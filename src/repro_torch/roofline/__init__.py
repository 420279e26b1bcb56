from repro_torch.roofline.analysis import (H100, Hardware, RooflineTerms,
                                           model_flops_estimate,
                                           roofline_terms)
from repro_torch.roofline.dispatch_count import (DispatchCounter,
                                                 DispatchStats, MemoryStats,
                                                 count_step)

__all__ = ["H100", "Hardware", "RooflineTerms", "model_flops_estimate",
           "roofline_terms", "DispatchCounter", "DispatchStats",
           "MemoryStats", "count_step"]
