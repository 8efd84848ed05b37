"""Serving layer of the port: engine, slots, pages, radix cache, scheduler,
the radix cache's snapshots, and the replica fleet behind its router."""
from repro_torch.serving.engine import (branch_cache,  # noqa: F401
                                        branch_pages, repeat_cache,
                                        reset_cache_rows, take_candidates)
from repro_torch.serving.gsi_engine import (EngineStats,  # noqa: F401
                                            GSIServingEngine, StepResult,
                                            StepTicket, merge_engine_stats)
from repro_torch.serving.pages import (PagePool, RadixIndex,  # noqa: F401
                                       pages_for)
from repro_torch.serving.replica import Replica, build_replicas  # noqa: F401
from repro_torch.serving.router import (HASH_TIERS, POLICIES,  # noqa: F401
                                        ReplicaRouter, preamble_hash,
                                        preamble_rendezvous)
from repro_torch.serving.scheduler import (GSIScheduler,  # noqa: F401
                                           Request, Response, StreamEvent,
                                           TokenStream)
from repro_torch.serving.snapshot import (index_records,  # noqa: F401
                                          load_snapshot, restore_records,
                                          restore_state, save_snapshot,
                                          snapshot_state)
from repro_torch.serving.slots import (SlotPool, pack_prompts,  # noqa: F401
                                       pack_tails)
