from repro_torch.configs.base import TenantConfig
from repro_torch.serving.engine import (DecodeEngine, Request, Result,
                                        make_engine_group)
from repro_torch.serving.event_loop import (EventLoop, EventLoopGroup,
                                            LoopFailure, Poller, PollStats,
                                            channel_affinity)
from repro_torch.serving.supervisor import (HealAction, Outcome,
                                            RetryBudget, Supervisor,
                                            SupervisorConfig)
from repro_torch.serving import cache_layout, chaos, slo

__all__ = ["DecodeEngine", "Request", "Result", "make_engine_group",
           "EventLoop", "EventLoopGroup", "LoopFailure", "Poller",
           "PollStats", "TenantConfig", "channel_affinity", "HealAction",
           "Outcome", "RetryBudget", "Supervisor", "SupervisorConfig",
           "cache_layout", "chaos", "slo"]
