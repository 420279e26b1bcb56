"""The paper's primary contribution, ported: delay weights (Eqs. 7, 9),
weighted aggregation (Eqs. 10-11), the RSU server, vehicle clients, the
event-driven async scheduler, and the named-scenario registry."""
from repro_torch.core.aggregation import (FedBuffAggregator, afl_update,
                                          fedasync_update, fedavg_update,
                                          literal_update, mafl_update,
                                          mix_update)
from repro_torch.core.client import Vehicle, VehicleData, local_update_many
from repro_torch.core.events import EventQueue, UploadEvent
from repro_torch.core.mafl import SimResult, evaluate, run_simulation
from repro_torch.core.scenarios import (Scenario, build_world, get_scenario,
                                        list_scenarios, run_scenario)
from repro_torch.core.server import RSUServer, RoundRecord
from repro_torch.core.weights import (combined_weight, training_weight,
                                      upload_weight)

__all__ = [
    "FedBuffAggregator", "afl_update", "fedasync_update", "fedavg_update",
    "literal_update", "mafl_update", "mix_update", "Vehicle", "VehicleData",
    "local_update_many", "EventQueue", "UploadEvent", "SimResult",
    "evaluate", "run_simulation", "Scenario", "build_world", "get_scenario",
    "list_scenarios", "run_scenario", "RSUServer", "RoundRecord",
    "combined_weight", "training_weight", "upload_weight",
]
