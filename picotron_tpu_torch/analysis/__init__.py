"""The port's `analysis/` (port of picotron_tpu/analysis/).

The analytic half: the cost model with its hardware tiers
(`cost_model.py`: the torus tier's arithmetic, the h100 switched tier
the port defaults to), its fit to measured steps (`calibration.py`) and
the layout planner (`planner.py`), all arithmetic on a Config.

The audit half (shardcheck): one step recorded through recording groups
on meta (`trace.py`, the counterpart of lowering on an abstract mesh),
audited by the collective-schedule rules (`collectives.py`), the slice
boundary (`boundary.py`), provenance (`dataflow.py`), the in-place and
stability hazards (`hazards.py`) and the signature proofs
(`variants.py`), beside the spec lint (`spec_lint.py`) and the source
lint (`source_lint.py`). `run_shardcheck` composes them, `preflight` is
the trainer's fail-fast subset, `python -m
picotron_tpu_torch.tools.shardcheck` the CLI. The names are the JAX
package's."""

from picotron_tpu_torch.analysis.boundary import (  # noqa: F401
    ClassifiedOp, SliceTopology, audit_boundary, classify_ops,
)
from picotron_tpu_torch.analysis.calibration import (  # noqa: F401
    MeasuredPoint, fit_calibration, load_measured_rows,
    measured_step_seconds, rank_agreement, row_to_point,
)
from picotron_tpu_torch.analysis.collectives import (  # noqa: F401
    audit_collectives, default_gather_budget,
)
from picotron_tpu_torch.analysis.cost_model import (  # noqa: F401
    H100, AxisLink, Calibration, CostModel, IciGeneration, StepCost,
    SwitchedGeneration, choose_tp_strategy, h100_tier, place_axes,
    resolve_generation, spearman, tp_strategy_table,
)
from picotron_tpu_torch.analysis.dataflow import (  # noqa: F401
    CollectiveSite, audit_dataflow, collect_sites, intended_rule,
)
from picotron_tpu_torch.analysis.hazards import (  # noqa: F401
    check_donation, check_in_place, check_recorded_stability,
    check_state_stability,
)
from picotron_tpu_torch.analysis.planner import (  # noqa: F401
    PlanPoint, best_point, candidate_configs, estimate_hbm_gib, plan,
    planner_gap, reprice_traced, slice_plans,
)
from picotron_tpu_torch.analysis.report import (  # noqa: F401
    Finding, Report, ShardcheckError,
)
from picotron_tpu_torch.analysis.runner import (  # noqa: F401
    ALL_CHECKS, PREFLIGHT_CHECKS, preflight, run_shardcheck,
)
from picotron_tpu_torch.analysis.source_lint import (  # noqa: F401
    lint_file, lint_sources,
)
from picotron_tpu_torch.analysis.spec_lint import (  # noqa: F401
    lint_param_specs, lint_specs, param_specs,
)
from picotron_tpu_torch.analysis.trace import (  # noqa: F401
    CollectiveOp, RecordedStep, record_train_step,
)
from picotron_tpu_torch.analysis.variants import (  # noqa: F401
    AbstractSig, audit_feeds, audit_variants, check_engine_feed,
    prove_disagg_programs, prove_serve_programs, prove_train_step,
    signature_of,
)
