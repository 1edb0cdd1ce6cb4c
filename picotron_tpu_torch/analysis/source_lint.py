"""AST source lint — package-wide rules a recorded step cannot see (port
of picotron_tpu/analysis/source_lint.py, its rules mapped to PyTorch).

A recorded step audits one config's path; some hazards live in the
source, on paths that config never visits. Rules:

- **reference-import** (error; the JAX `jax-core`): `jax` or the JAX
  package (`picotron_tpu`) imported. The port stands alone: its own
  copy of what it needs, never the reference's (the card's machine has
  no JAX at all).
- **torch-private** (warning; the JAX `jax-private`): a `torch._*`
  namespace (`torch._foreach_*`, `torch._C`, `torch._dynamo`). Its
  names move between releases; sometimes the only way, always worth an
  eyebrow.
- **host-sync** (error; the JAX `host-callback`): `.item()`,
  `.tolist()`, `.cpu()` or `torch.cuda.synchronize()` in `models/`,
  `ops/` or `parallel/`, the code that runs inside a step. Each blocks
  the host on the device stream (and breaks a CUDA graph capture): the
  step-time surprise only a card would reveal.
- **loop-collective** (warning): a `parallel/comm.py` collective (a
  `comm.` function or a communicator's method: `all_reduce`,
  `all_gather`, `reduce_scatter`, `all_to_all`, `hop`, `exchange`, ...)
  called inside a Python `for`/`while` loop: one small op per
  iteration where one batched op would do, the unbatched-collective
  smell the cost model prices per-op latency for. A collective inside a
  function *defined* in a loop does not flag. Deliberate ones (the cp
  ring's hops, the per-tensor grad all-reduce) suppress per line.
- **implicit-device** (warning; the JAX `uncommitted-device-put`): a
  tensor factory (`torch.zeros`, `empty`, `ones`, `full`, `arange`,
  `tensor`, `randn`, ...) in those directories without `device=`. It
  lands on the CPU whatever the step runs on: a host tensor joining a
  device program (`analysis/variants.py`). `*_like` factories inherit
  a device and do not flag.
- **raw-collective** (error): a `torch.distributed` collective
  (`all_reduce`, `all_gather*`, `reduce_scatter*`, `all_to_all*`,
  `broadcast`, `send`, `recv`, `isend`, `irecv`, `batch_isend_irecv`,
  `barrier`, ...) outside `parallel/comm.py`: it escapes both the
  collective counts and the recorder (`analysis/trace.py`).

Suppress a finding with a `# shardcheck: ok` comment on the line (give
the reason after it).
"""

from __future__ import annotations

import ast
import os

from picotron_tpu_torch.analysis.report import ERROR, WARNING, Report

CHECK = "source_lint"

# the directories whose code runs inside a step
_STEP_DIRS = ("models", "ops", "parallel")
_HOST_SYNCS = {"item", "tolist", "cpu"}
_COMM_CALLS = {"all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "all_gather_into", "reduce_scatter_into", "all_to_all_into",
               "send_recv", "hop", "exchange", "mean"}
_RAW_DIST = {"all_reduce", "all_gather", "all_gather_into_tensor",
             "all_gather_single", "all_gather_object", "reduce_scatter",
             "reduce_scatter_tensor", "reduce_scatter_single",
             "all_to_all", "all_to_all_single", "broadcast",
             "broadcast_object_list", "reduce", "gather", "scatter", "send",
             "recv", "isend", "irecv", "batch_isend_irecv", "barrier",
             "all_reduce_coalesced", "monitored_barrier"}
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
              "rand", "randn", "randint", "linspace", "eye",
              "empty_strided"}
_COMM_MODULE = os.path.join("parallel", "comm.py")


def _attr_chain(node) -> list:
    """['torch', 'cuda', 'synchronize'] for torch.cuda.synchronize; []
    if not a plain chain of names."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _is_reference(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "picotron_tpu")


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, suppressed: set, rep: Report):
        self.relpath = relpath
        self.suppressed = suppressed
        self.rep = rep
        self._loop_depth = 0
        parts = relpath.replace(os.sep, "/").split("/")
        self.in_step = any(d in parts[:-1] for d in _STEP_DIRS)
        self.is_comm = relpath.replace(os.sep, "/").endswith(
            _COMM_MODULE.replace(os.sep, "/"))
        # names bound to torch.distributed in this file
        self.dist_names = {"dist"} if not self.is_comm else set()

    def _add(self, node, severity, message):
        if node.lineno in self.suppressed:
            return
        self.rep.add(CHECK, severity, f"{self.relpath}:{node.lineno}",
                     message)

    # -- loop scope: a nested function resets it ---------------------------

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_While = visit_AsyncFor = _visit_loop

    def _visit_fn(self, node):
        saved, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = saved

    visit_FunctionDef = visit_AsyncFunctionDef = visit_Lambda = _visit_fn

    # -- imports -----------------------------------------------------------

    def visit_Import(self, node):
        for alias in node.names:
            if _is_reference(alias.name):
                self._add(node, ERROR,
                          f"import of {alias.name!r}: the port imports "
                          f"neither jax nor the JAX package (keep a copy of "
                          f"what it needs)")
            elif alias.name.startswith("torch._"):
                self._add(node, WARNING,
                          f"private-namespace import {alias.name!r}")
            elif (alias.name == "torch.distributed" and alias.asname
                  and not self.is_comm):
                self.dist_names.add(alias.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if node.level == 0 and _is_reference(mod):
            self._add(node, ERROR,
                      f"import from {mod!r}: the port imports neither jax "
                      f"nor the JAX package")
        elif mod.startswith("torch._"):
            self._add(node, WARNING,
                      f"private-namespace import from {mod!r}")
        elif mod == "torch" and not self.is_comm:
            self.dist_names |= {a.asname or a.name for a in node.names
                                if a.name == "distributed"}
        self.generic_visit(node)

    # -- calls and attributes ----------------------------------------------

    def visit_Attribute(self, node):
        chain = _attr_chain(node)
        if len(chain) >= 2 and chain[0] == "torch" and \
                chain[1].startswith("_"):
            self._add(node, WARNING,
                      f"private namespace {'.'.join(chain[:2])} "
                      f"({'.'.join(chain)}): its names move between "
                      f"torch releases")
        self.generic_visit(node)

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        name = chain[-1] if chain else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if self.in_step:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_SYNCS and not node.args
                    and not node.keywords):
                self._add(node, ERROR,
                          f".{node.func.attr}() in step code: it blocks the "
                          f"host on the device stream (and breaks a CUDA "
                          f"graph capture) — keep the value on the device")
            if chain[:3] == ["torch", "cuda", "synchronize"]:
                self._add(node, ERROR,
                          "torch.cuda.synchronize() in step code: it "
                          "blocks the host on the device stream")
            if (len(chain) == 2 and chain[0] == "torch"
                    and chain[1] in _FACTORIES
                    and not any(kw.arg == "device" for kw in node.keywords)):
                self._add(node, WARNING,
                          f"torch.{chain[1]} without device=: the tensor "
                          f"lands on the CPU whatever the step runs on — "
                          f"a host tensor joining a device program; pass "
                          f"device= (or use a *_like factory)")
        dist_call = ((len(chain) == 2 and chain[0] in self.dist_names)
                     or (len(chain) == 3 and chain[:2] == ["torch",
                                                           "distributed"]
                         and not self.is_comm))
        if dist_call and chain[-1] in _RAW_DIST:
            self._add(node, ERROR,
                      f"torch.distributed.{chain[-1]} outside "
                      f"parallel/comm.py: it escapes the collective counts "
                      f"and the recorder (analysis/trace.py) — route it "
                      f"through a parallel/comm.py function")
        if (self._loop_depth > 0 and name in _COMM_CALLS and chain
                and len(chain) >= 2 and not self.is_comm
                and (chain[0] == "comm" or "comm" in chain[-2]
                     or chain[-2] in ("cp", "pp", "ep", "stats"))):
            self._add(node, WARNING,
                      f"collective {'.'.join(chain)} issued inside a Python "
                      f"loop: one op per iteration where a batched "
                      f"collective would issue one — the unbatched-"
                      f"collective smell the cost model prices per-op "
                      f"latency for. Batch it, or suppress with "
                      f"'# shardcheck: ok' and the reason if the loop is "
                      f"deliberate")
        self.generic_visit(node)


def _suppressed_lines(src: str) -> set:
    return {i + 1 for i, line in enumerate(src.splitlines())
            if "# shardcheck: ok" in line}


def lint_file(path: str, relpath: str = None) -> Report:
    rep = Report()
    relpath = relpath or path
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        rep.add(CHECK, ERROR, f"{relpath}:{e.lineno}",
                f"syntax error: {e.msg}")
        return rep
    _Visitor(relpath, _suppressed_lines(src), rep).visit(tree)
    return rep


def lint_sources(roots=None) -> Report:
    """Lint every .py file under `roots` (default: the picotron_tpu_torch
    package)."""
    if roots is None:
        roots = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    rep = Report()
    n_files = 0
    for root in roots:
        if os.path.isfile(root):
            files = [root]
            base = os.path.dirname(root)
        else:
            base = os.path.dirname(root.rstrip(os.sep))
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(root) for f in fs
                if f.endswith(".py"))
        for path in files:
            n_files += 1
            rep.extend(lint_file(path, os.path.relpath(path, base)))
    rep.info[CHECK] = {"files": n_files}
    return rep
