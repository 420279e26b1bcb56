from repro_torch.data.synthetic import synth_mnist, synth_tokens
from repro_torch.data.partition import partition_vehicles
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["synth_mnist", "synth_tokens", "partition_vehicles",
           "TokenPipeline"]
