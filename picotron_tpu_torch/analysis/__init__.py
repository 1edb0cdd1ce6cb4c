"""The analytic half of the JAX package's `analysis/` (port): the cost
model with its hardware tiers (`cost_model.py`: the torus tier's
arithmetic, the h100 switched tier the port defaults to), its fit to
measured steps (`calibration.py`) and the layout planner
(`planner.py`), all arithmetic on a Config. The audit half (the
collective-schedule, dataflow, boundary and variant audits and the lint
rules, which read a traced program in the JAX package) is ROADMAP Queue
1 item 13b."""

from picotron_tpu_torch.analysis.calibration import (  # noqa: F401
    MeasuredPoint, fit_calibration, load_measured_rows,
    measured_step_seconds, rank_agreement, row_to_point,
)
from picotron_tpu_torch.analysis.cost_model import (  # noqa: F401
    H100, AxisLink, Calibration, CostModel, IciGeneration, StepCost,
    SwitchedGeneration, choose_tp_strategy, h100_tier, place_axes,
    resolve_generation, spearman, tp_strategy_table,
)
from picotron_tpu_torch.analysis.planner import (  # noqa: F401
    PlanPoint, best_point, candidate_configs, estimate_hbm_gib, plan,
    planner_gap, slice_plans,
)
