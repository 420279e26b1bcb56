from repro_torch.channel.mobility import CorridorMobility, Mobility
from repro_torch.channel.fading import (RayleighAR1, SlotGainCache,
                                        slot_gain_table)
from repro_torch.channel.rate import (shannon_rate, upload_delay,
                                      training_delay)
from repro_torch.channel.params import ChannelParams

__all__ = ["Mobility", "CorridorMobility", "RayleighAR1", "SlotGainCache",
           "slot_gain_table", "shannon_rate", "upload_delay",
           "training_delay", "ChannelParams"]
