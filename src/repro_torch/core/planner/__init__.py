"""The Oases planner (paper §4): cost model, ILP and calibration, the
port's copy of ``repro.core.planner`` with the same ``__all__``.  The
port's own H100 fixture is ``costmodel.H100_80GB_HBM3``."""
from repro_torch.core.planner.costmodel import (COMMODITY_25GBE, HWConfig,
                                                NVLINK_BOX, V5E,
                                                decode_step_time,
                                                estimate_iteration,
                                                layer_blocks, node_costs,
                                                overlapped_time,
                                                overlapped_time_2d,
                                                p2p_hop_seconds,
                                                pipeline_time, stage_hw)
from repro_torch.core.planner.calibrate import calibrated_hw
from repro_torch.core.planner.ilp import (JointPlanResult, PlanResult,
                                          ServingPlanResult, expand_options,
                                          plan, plan_joint, plan_serving,
                                          replan)

__all__ = ["COMMODITY_25GBE", "HWConfig", "NVLINK_BOX", "V5E",
           "calibrated_hw", "decode_step_time", "estimate_iteration",
           "layer_blocks", "node_costs", "overlapped_time",
           "overlapped_time_2d", "p2p_hop_seconds", "pipeline_time",
           "stage_hw", "JointPlanResult", "PlanResult",
           "ServingPlanResult", "expand_options", "plan", "plan_joint",
           "plan_serving", "replan"]
