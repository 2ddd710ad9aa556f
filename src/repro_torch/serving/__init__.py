from repro_torch.serving.engine import (DecodeEngine, Request, Result,
                                        make_engine_group)
from repro_torch.serving.event_loop import (EventLoop, EventLoopGroup,
                                            Poller, PollStats,
                                            channel_affinity)
from repro_torch.serving import cache_layout

__all__ = ["DecodeEngine", "Request", "Result", "make_engine_group",
           "EventLoop", "EventLoopGroup", "Poller", "PollStats",
           "channel_affinity", "cache_layout"]
