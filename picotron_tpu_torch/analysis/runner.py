"""Orchestration: run the shardcheck analyzers for a config, cheap first
(port of picotron_tpu/analysis/runner.py).

`run_shardcheck` is the whole pass (the CLI, the tests); `preflight` is
the fail-fast subset the trainer runs before its first step: the spec
lint, the in-place and stability hazards, provenance, the signature
proofs and the slice audit, all over one recorded step
(`analysis/trace.py`: on meta at the config's own shapes, whatever the
run's device; the step itself then runs on the card). Set
PICOTRON_PREFLIGHT=0 to skip it (e.g. when iterating on a config the
analyzers flag on purpose).
"""

from __future__ import annotations

import os

from picotron_tpu_torch.analysis.report import Report

ALL_CHECKS = ("spec", "source", "collectives", "boundary", "provenance",
              "variants", "donation", "stability")
PREFLIGHT_CHECKS = ("spec", "donation", "stability", "provenance",
                    "variants", "boundary")

# the sections a step depends on -> the green report of a passed preflight
_PASSED: dict = {}


def run_shardcheck(cfg, *, checks=ALL_CHECKS, budget_bytes=None,
                   source_roots=None, cost_model=None, slices=None,
                   dcn_axes=None, recorded=None) -> Report:
    """Run the requested analyzers for `cfg`; returns the merged Report.
    The checks on the step share one recording (`recorded`, or one made
    here). The spec lint runs first, and a spec it rejects stops the
    pass there: such a layout usually cannot build its model either."""
    from picotron_tpu_torch.analysis.spec_lint import lint_param_specs

    rep = Report()
    if "spec" in checks:
        spec_rep = lint_param_specs(cfg)
        rep.extend(spec_rep)
        if not spec_rep.ok():
            return rep
    if "source" in checks:
        from picotron_tpu_torch.analysis.source_lint import lint_sources

        rep.extend(lint_sources(source_roots))
    step_checks = {"collectives", "boundary", "provenance", "variants",
                   "donation", "stability"} & set(checks)
    if not step_checks:
        return rep
    if recorded is None:
        from picotron_tpu_torch.analysis.trace import record_train_step

        recorded = record_train_step(cfg)
    rep.info["trace"] = {"device": recorded.device,
                         "ranks": sorted(recorded.programs),
                         "ops": len(recorded.ops),
                         "seconds": round(recorded.seconds, 3)}
    if "collectives" in step_checks:
        from picotron_tpu_torch.analysis.collectives import audit_collectives

        rep.extend(audit_collectives(cfg, recorded=recorded,
                                     budget_bytes=budget_bytes,
                                     cost_model=cost_model))
    if "boundary" in step_checks:
        from picotron_tpu_torch.analysis.boundary import audit_boundary

        rep.extend(audit_boundary(cfg, recorded=recorded, n_slices=slices,
                                  dcn_axes=dcn_axes, cost_model=cost_model))
    if "provenance" in step_checks:
        from picotron_tpu_torch.analysis.dataflow import audit_dataflow

        rep.extend(audit_dataflow(cfg, recorded=recorded,
                                  cost_model=cost_model))
    if "variants" in step_checks:
        from picotron_tpu_torch.analysis.variants import audit_variants

        rep.extend(audit_variants(cfg, recorded=recorded))
    if "donation" in step_checks:
        from picotron_tpu_torch.analysis.hazards import check_donation

        rep.extend(check_donation(recorded))
    if "stability" in step_checks:
        from picotron_tpu_torch.analysis.hazards import (
            check_recorded_stability,
        )

        rep.extend(check_recorded_stability(recorded))
    return rep


def preflight(cfg, *, checks=PREFLIGHT_CHECKS) -> Report:
    """The trainer's fail-fast pre-flight. Raises ShardcheckError on
    errors (the exception text IS the rendered report); returns the
    report otherwise. A config whose step-shaping sections (model,
    training, distributed, pipeline, resilience, serve) passed before in
    this process is not recorded again. PICOTRON_PREFLIGHT=0 disables
    it."""
    if os.environ.get("PICOTRON_PREFLIGHT", "1") == "0":
        return Report()
    key = repr((cfg.model, cfg.training, cfg.distributed, cfg.pipeline,
                cfg.resilience, cfg.serve, tuple(checks)))
    if key not in _PASSED:
        rep = run_shardcheck(cfg, checks=checks)
        rep.raise_if_errors()
        _PASSED[key] = rep
    return _PASSED[key]
