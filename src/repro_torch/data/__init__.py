from repro_torch.data.synthetic import synth_mnist
from repro_torch.data.partition import partition_vehicles

__all__ = ["synth_mnist", "partition_vehicles"]
