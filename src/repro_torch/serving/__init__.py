"""Serving layer of the port: engine, slots, pages, radix cache, scheduler."""
from repro_torch.serving.engine import (branch_cache,  # noqa: F401
                                        branch_pages, repeat_cache,
                                        reset_cache_rows, take_candidates)
from repro_torch.serving.gsi_engine import (EngineStats,  # noqa: F401
                                            GSIServingEngine, StepResult,
                                            StepTicket)
from repro_torch.serving.pages import (PagePool, RadixIndex,  # noqa: F401
                                       pages_for)
from repro_torch.serving.scheduler import (GSIScheduler,  # noqa: F401
                                           Request, Response)
from repro_torch.serving.slots import (SlotPool, pack_prompts,  # noqa: F401
                                       pack_tails)
