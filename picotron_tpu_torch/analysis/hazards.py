"""In-place and stability hazards of a recorded step (port of
picotron_tpu/analysis/hazards.py).

The JAX checks read the lowered step: every TrainState buffer must be
donated, and the step's output avals must equal its input avals. Eager
PyTorch has neither donation nor a trace, so each becomes what it
guards in this framework, checked on the state before and after one
recorded step (`analysis/trace.py`: on meta, so the preflight can run
them before the first real step):

- **donation -> in place.** The step updates every parameter, grad
  buffer, master weight and moment in place (`optimizer.py`: the AdamW
  kernel writes into the tensors it is given). A leaf that the step
  replaced — a new tensor object, or the same Parameter over new
  storage (`p.data = ...`) — holds its old and its new memory at once
  for as long as anything refers to the old one, and breaks every
  holder of the old tensor (the fused engine's weight copies, the
  checkpoint's views): what a lost donation costs in JAX. Each is named.
- **stability.** Every state leaf keeps its (shape, dtype, device,
  requires_grad) across the step: a counter promoted to float64, a
  moment cast to bf16 or a parameter moved off its device is a state
  the next step does not expect (the JAX "recompile" check's
  counterpart: a CUDA graph captured over the step, or the
  checkpoint's restore, is keyed on exactly these).
"""

from __future__ import annotations

from picotron_tpu_torch.analysis.report import ERROR, Report
from picotron_tpu_torch.analysis.trace import state_snapshot

DONATION = "donation"
STABILITY = "recompile"


def check_in_place(before: dict, state) -> Report:
    """`before` (`trace.state_snapshot` taken before the step) against
    `state` after it: every leaf the same tensor over the same storage."""
    rep = Report()
    after = state_snapshot(state)
    for name in sorted(set(before) - set(after)):
        rep.add(DONATION, ERROR, name,
                "state leaf disappeared across the step")
    kept = 0
    for name, (tid, sid, shape, dtype, *_rest) in before.items():
        if name not in after:
            continue
        ntid, nsid = after[name][:2]
        if tid == ntid and sid == nsid:
            kept += 1
            continue
        what = ("a new tensor" if tid != ntid
                else "the same tensor over new storage")
        rep.add(DONATION, ERROR, name,
                f"state leaf ({dtype}{list(shape)}) was replaced by "
                f"{what} instead of updated in place: the step holds "
                f"its old AND new memory while anything refers to the "
                f"old one, and every holder of the old tensor (fused "
                f"weight copies, checkpoint views) goes stale — update "
                f"it in place (copy_, the optimizer kernels' outputs)")
    rep.info[DONATION] = {"state_leaves": len(before), "in_place": kept}
    return rep


def check_state_stability(before: dict, state) -> Report:
    """Every state leaf keeps (shape, dtype, device, requires_grad)."""
    rep = Report()
    after = state_snapshot(state)
    for name, (_, _, *sig) in before.items():
        if name not in after:
            continue
        new = list(after[name][2:])
        if new != sig:
            fields = ("shape", "dtype", "device", "requires_grad")
            diff = ", ".join(f"{f} {a} -> {b}"
                             for f, a, b in zip(fields, sig, new) if a != b)
            rep.add(STABILITY, ERROR, name,
                    f"state leaf changes across the step ({diff}): the "
                    f"next step sees a state the first did not (a "
                    f"captured CUDA graph or a restore keyed on it "
                    f"breaks); keep its dtype and device fixed")
    rep.info[STABILITY] = {"state_leaves": len(before)}
    return rep


def check_donation(recorded) -> Report:
    """`check_in_place` over every recorded rank's state."""
    rep = Report()
    total = kept = 0
    for rank in sorted(recorded.states):
        sub = check_in_place(recorded.before[rank], recorded.states[rank])
        rep.findings.extend(sub.findings)
        total += sub.info[DONATION]["state_leaves"]
        kept += sub.info[DONATION]["in_place"]
    # the JAX keys: every leaf "donated" is every leaf updated in place
    rep.info[DONATION] = {"state_leaves": total, "donated": kept}
    return rep


def check_recorded_stability(recorded) -> Report:
    """`check_state_stability` over every recorded rank's state."""
    rep = Report()
    total = 0
    for rank in sorted(recorded.states):
        sub = check_state_stability(recorded.before[rank],
                                    recorded.states[rank])
        rep.findings.extend(sub.findings)
        total += sub.info[STABILITY]["state_leaves"]
    rep.info[STABILITY] = {"state_leaves": total}
    return rep

