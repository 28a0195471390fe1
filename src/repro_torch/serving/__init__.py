from repro_torch.serving.config import ServeConfig
from repro_torch.serving.draft_cache import DraftCache
from repro_torch.serving.engine import (ChunkSeg, ChunkWork,
                                        ContinuousServingEngine, ProbeState,
                                        ServeResult, ServingEngine,
                                        SlotStepView, Spill,
                                        StaticQueueResult,
                                        chunk_supported, chunked_prefill,
                                        extract_trajectories,
                                        init_probe_state, make_serve_step,
                                        prefix_len, probe_update,
                                        reset_probe_slot, serve_queue_static,
                                        write_probe_slot)
from repro_torch.serving.groups import RequestGroup, group_requests, make_group
from repro_torch.serving.kv_pool import (NULL_BLOCK, BlockPool, blocks_needed,
                                         pad_row, prompt_key)
from repro_torch.serving.policy import (ComposeView, EDFPolicy, FIFOPolicy,
                                        HostPressure, PlacementPolicy,
                                        PressurePlacement, PriorityPolicy,
                                        RoundRobinPlacement, SchedulingPolicy,
                                        TTFTAwarePolicy, make_placement,
                                        make_policy)
from repro_torch.serving.replay import (GroupFleet, make_group_fleet,
                                        replay_model, replay_params,
                                        replay_requests, serve_replay,
                                        served_stop_times)
from repro_torch.serving.request import (FleetMetrics, Request, RequestState,
                                         latency_stats, make_request,
                                         spec_stats)
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.scheduler import OrcaScheduler

__all__ = ["BlockPool", "ChunkSeg", "ChunkWork", "ComposeView",
           "ContinuousServingEngine", "DraftCache", "EDFPolicy",
           "FIFOPolicy", "FleetMetrics", "FleetRouter", "GroupFleet",
           "HostPressure", "NULL_BLOCK", "OrcaScheduler", "PlacementPolicy",
           "PressurePlacement", "PriorityPolicy", "ProbeState", "Request",
           "RequestGroup", "RequestState", "RoundRobinPlacement",
           "SchedulingPolicy",
           "ServeConfig", "ServeResult", "ServingEngine", "SlotStepView",
           "Spill", "StaticQueueResult", "TTFTAwarePolicy",
           "blocks_needed", "chunk_supported", "chunked_prefill",
           "extract_trajectories", "group_requests", "init_probe_state",
           "latency_stats", "make_group", "make_group_fleet",
           "make_placement", "make_policy",
           "make_request", "make_serve_step", "pad_row",
           "prefix_len", "probe_update", "prompt_key", "replay_model",
           "replay_params", "replay_requests", "reset_probe_slot",
           "serve_queue_static", "serve_replay", "served_stop_times",
           "spec_stats",
           "write_probe_slot"]
