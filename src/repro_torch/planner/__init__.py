"""Profile-guided pipeline planner (twin of ``repro/planner``).

  ``profiler``     per-layer cost profiles (analytic, or one block timed
                   on the card).
  ``partition``    PipeDream's bottleneck-minimizing dynamic program
                   splitting the layers into stages, and the uniform
                   split.
  ``schedule_ir``  the event-timeline IR and its emitters (round-robin
                   1F1B, GPipe, streaming, PipeDream-flush, 2BW,
                   interleaved), with staleness, bubble and stash depths
                   derived from the timeline; the lowering of a round to
                   an ``EventTable`` and ``DeviceStreams``, and of a
                   serving round to a ``ServeTable`` and ``ServeStreams``.
  ``verify``       the static verifier of those artifacts and its
                   mutation harness (``python -m
                   repro_torch.planner.verify``).
  ``api``          ``plan(config, n_stages) -> PipelinePlan`` and
                   ``serve_plan(...) -> ServePlan``.

Quick start::

    from repro_torch.planner import plan
    p = plan(cfg, n_stages=4, schedule="1f1b", partitioner="dp")
    print(p.summary())          # partition, s_fwd/s_bwd, bottleneck
"""
from repro_torch.planner.api import (PipelinePlan, ROUND_SCHEDULES,
                                     SCHEDULES, ServePlan,
                                     check_against_closed_forms, plan,
                                     serve_plan)
from repro_torch.planner.partition import (Partition, dp_split,
                                           profile_stage_costs, uniform)
from repro_torch.planner.profiler import (LayerProfile, ModelProfile,
                                          profile_model, synthetic_profile)
from repro_torch.planner.schedule_ir import (DeviceStreams, Event,
                                             EventTable, Schedule,
                                             ServeStreams, ServeTable,
                                             compile_device_streams,
                                             compile_event_table,
                                             compile_serve_streams,
                                             compile_serve_table, emit,
                                             gpipe, interleaved_1f1b,
                                             one_f_one_b, pipedream_2bw,
                                             round_compute_events,
                                             round_compute_program,
                                             round_robin_1f1b,
                                             serve_round_events, streaming)
from repro_torch.planner.verify import (VerificationError, VerifyReport,
                                        Violation, check_plan,
                                        check_serve_plan,
                                        verify_device_streams,
                                        verify_event_table, verify_plan,
                                        verify_request_trace,
                                        verify_serve_streams,
                                        verify_serve_table)

__all__ = [
    "PipelinePlan", "SCHEDULES", "ROUND_SCHEDULES", "plan",
    "ServePlan", "serve_plan",
    "check_against_closed_forms",
    "Partition", "dp_split", "profile_stage_costs", "uniform",
    "LayerProfile", "ModelProfile", "profile_model", "synthetic_profile",
    "Event", "Schedule", "emit", "gpipe", "round_robin_1f1b", "streaming",
    "one_f_one_b", "pipedream_2bw", "interleaved_1f1b",
    "EventTable", "compile_event_table", "round_compute_program",
    "DeviceStreams", "compile_device_streams", "round_compute_events",
    "ServeTable", "ServeStreams", "serve_round_events",
    "compile_serve_table", "compile_serve_streams",
    "VerificationError", "VerifyReport", "Violation", "check_plan",
    "verify_event_table", "verify_device_streams", "verify_plan",
    "check_serve_plan", "verify_serve_table", "verify_serve_streams",
    "verify_request_trace",
]
