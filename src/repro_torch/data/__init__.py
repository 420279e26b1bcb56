from repro_torch.data.synthetic import synth_mnist, synth_tokens
from repro_torch.data.partition import partition_vehicles

__all__ = ["synth_mnist", "synth_tokens", "partition_vehicles"]
