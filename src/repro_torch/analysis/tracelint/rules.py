"""The tracelint rule families, in PyTorch idiom. Counterpart of
``repro/analysis/tracelint/rules.py``.

Each rule is a function ``(LintModule, Context) -> [Finding]``; the
shared ``Context`` carries what spans files (the declared mesh axes).
Rules are syntactic: they read the AST and the port's idioms (``torch``,
``np``, ``kops``/``ops`` for ``kernels.ops``, ``LAUNCH_COUNTS``). A rule
that cannot decide stays silent, so every finding is worth reading.

Rule families (ids in ``engine.RULES``):

1. ``host-transfer``: in hot modules (``config.HOT_MODULES``), a read of
   a device value on the host: ``.item()``, ``.tolist()``, ``.cpu()``,
   ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a value not
   plainly on the host (a constant, ``len``, a shape, ``numel``, a
   ``cfg`` field, a numpy call...),
   ``torch.cuda.synchronize`` and ``Event`` / ``Stream.synchronize()``,
   and ``np.asarray`` / ``np.array`` (of a tensor, as far as syntax can
   tell).
2. ``generator`` (the reference's ``prng-reuse``): a draw from the global
   RNG (``torch.rand*``, ``randn``, ``randint``, ``randperm``,
   ``multinomial``, ``bernoulli``, ``normal``, ``poisson`` or a tensor's
   ``normal_`` / ``uniform_`` / ``exponential_`` / ``random_`` /
   ``bernoulli_`` ... without ``generator=``; the ``*_like`` draws, which
   take none), and two ``manual_seed`` calls in one scope with the same
   constant or the same name (two streams that collide).
3. ``inplace-alias`` (the reference's ``donation-reuse``): state that a
   module's contracts update in place (the names in their ``state=``)
   handed to another thread without a ``clone``: an argument of
   ``put`` / ``put_nowait`` / ``submit`` or a ``Thread(args=...)`` that
   names it (the ``ActorSnapshot`` rule: a consumer must own its copy).
4. ``sharding-axes``: literal axis names given to ``MeshRules``,
   ``axis_size``, ``axis_index``, ``standard_rules(data_axes=)``,
   ``param_spec``, ``AxisMesh`` or a ``mesh.shape[...]`` must be axes
   the scan declares (``launch/mesh.py``'s axis dicts and every
   ``axis_names`` tuple); plus the candidate-merge ordering contract of
   ``distributed/sharding.py``.
5. ``kernel-launch`` (the reference's ``pallas-call``), in ``kernels/``:
   a function that calls the built extension (``torch.ops.repro_torch``)
   without bumping ``LAUNCH_COUNTS``, or bumps it without calling it; a
   ``try`` whose body builds or launches a kernel (a fallback); a
   module-scope import of ``triton`` or of ``torch.utils.cpp_extension``
   (a kernel is built only when first called); an ``is_available()``
   test that picks a path (a kernel's route is its operand's device); and
   in ``csrc/*.cu`` a literal ``__shared__`` array over the static budget
   or a literal dynamic shared-memory size over the dynamic one.
6. ``config-mutation``: ``torch.backends.*`` assignments,
   ``set_float32_matmul_precision``, ``set_default_dtype`` /
   ``set_default_device``, ``use_deterministic_algorithms``,
   ``torch.cuda.set_sync_debug_mode`` and ``os.environ`` writes only in
   ``repro_torch/__init__.py``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set

from repro_torch.analysis.tracelint.config import (SMEM_DYNAMIC_BYTES,
                                                   SMEM_STATIC_BYTES,
                                                   LintConfig,
                                                   is_config_file,
                                                   is_contract_file, is_hot,
                                                   is_kernel_module,
                                                   is_mesh_decl_file)
from repro_torch.analysis.tracelint.engine import Finding, LintModule


# --------------------------------------------------------------------------- #
# AST helpers
# --------------------------------------------------------------------------- #

def dotted(node) -> Optional[str]:
    """Attribute/Name chain -> 'a.b.c' (None for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def ends(name: Optional[str], *suffixes: str) -> bool:
    if name is None:
        return False
    return any(name == s or name.endswith("." + s) for s in suffixes)


def const_str_items(node) -> Optional[List[str]]:
    """'x' or ('x','y') of literal strings -> list; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def walk_skipping_defs(body: Sequence[ast.stmt]):
    """Yield all nodes under ``body`` without descending into nested
    function/class definitions."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node                   # a def: the node itself, not its body
        if isinstance(node, defs):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _scopes(mod: LintModule):
    """The module and every function: each a scope of its own."""
    return [mod.tree] + [n for n in ast.walk(mod.tree)
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))]


# --------------------------------------------------------------------------- #
# shared context
# --------------------------------------------------------------------------- #

@dataclass
class Context:
    cfg: LintConfig
    mesh_axes: FrozenSet[str]
    mesh_axes_declared: bool      # False -> fell back to the default set


def build_context(modules: Dict[str, LintModule], cfg: LintConfig
                  ) -> Context:
    """Pre-pass: the mesh-axis universe, from every ``axis_names = (...)``
    of literal strings in the scan and the string keys of every dict
    literal in the mesh declaration files."""
    axes: Set[str] = set()
    for mod in modules.values():
        decl = is_mesh_decl_file(mod.path)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "axis_names"
                    for t in node.targets):
                axes.update(const_str_items(node.value) or ())
            elif decl and isinstance(node, ast.Dict):
                axes.update(k.value for k in node.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str))
    if axes:
        return Context(cfg=cfg, mesh_axes=frozenset(axes),
                       mesh_axes_declared=True)
    return Context(cfg=cfg, mesh_axes=frozenset(cfg.default_mesh_axes),
                   mesh_axes_declared=False)


# --------------------------------------------------------------------------- #
# rule 1: host-transfer
# --------------------------------------------------------------------------- #

_HOST_METHODS_NOARG = ("item", "tolist")
_HOST_METHODS = ("cpu", "numpy")
_NP_HOST_CALLS = ("np.asarray", "numpy.asarray", "np.array", "numpy.array")
# a value these produce is on the host already
_HOST_INT_METHODS = ("numel", "dim", "size", "element_size", "stride",
                     "nelement", "get_device")
_HOST_INT_ATTRS = ("shape", "ndim", "itemsize", "nbytes")
_HOST_MODULES = ("math.", "np.", "numpy.", "os.", "time.", "sys.")
# a config dataclass's fields are host values
_CONFIG_NAMES = ("cfg.", "self.cfg.")


def _on_host(node) -> bool:
    """Whether an expression is plainly a host value (so ``int()`` of it
    reads nothing back): a constant, ``len(...)``, a shape, ``numel()``
    and the like, a math / numpy call, and arithmetic of those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _on_host(node.operand)
    if isinstance(node, ast.BinOp):
        return _on_host(node.left) and _on_host(node.right)
    if isinstance(node, ast.Attribute):
        return (node.attr in _HOST_INT_ATTRS
                or (dotted(node) or "").startswith(_CONFIG_NAMES))
    if isinstance(node, ast.Subscript):
        return (isinstance(node.value, ast.Attribute)
                and node.value.attr in _HOST_INT_ATTRS)
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        if name == "len" or name.startswith(_HOST_MODULES):
            return True
        return (isinstance(node.func, ast.Attribute)
                and (node.func.attr in _HOST_INT_METHODS
                     or _on_host(node.func.value)))
    return False


def check_host_transfer(mod: LintModule, ctx: Context) -> List[Finding]:
    if not is_hot(mod.path, ctx.cfg):
        return []
    out: List[Finding] = []

    def f(node, msg):
        out.append(Finding(mod.path, node.lineno, "host-transfer", msg))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if attr == "synchronize":
            f(node, f"`{name or '.synchronize'}()` waits for the device "
                    f"in a hot module — move it off the hot path or "
                    f"allow with a reason")
        elif attr in _HOST_METHODS_NOARG and not node.args \
                and not node.keywords:
            f(node, f"`.{attr}()` copies a device value to the host in a "
                    f"hot module")
        elif attr in _HOST_METHODS:
            f(node, f"`.{attr}()` copies a tensor to the host in a hot "
                    f"module")
        elif name in _NP_HOST_CALLS:
            f(node, f"`{name}` forces a device->host copy in a hot module")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("float", "int", "bool")
              and len(node.args) == 1 and not _on_host(node.args[0])):
            f(node, f"`{node.func.id}(...)` reads a device value on the "
                    f"host in a hot module")
    return out


# --------------------------------------------------------------------------- #
# rule 2: the generator discipline
# --------------------------------------------------------------------------- #

_GLOBAL_DRAWS = ("torch.rand", "torch.randn", "torch.randint",
                 "torch.randperm", "torch.multinomial", "torch.bernoulli",
                 "torch.normal", "torch.poisson")
_LIKE_DRAWS = ("torch.rand_like", "torch.randn_like", "torch.randint_like")
_INPLACE_DRAWS = ("normal_", "uniform_", "exponential_", "random_",
                  "bernoulli_", "geometric_", "cauchy_", "log_normal_")
_METHOD_DRAWS = ("multinomial", "bernoulli")


def check_generator(mod: LintModule, ctx: Context) -> List[Finding]:
    out: List[Finding] = []

    def f(node, msg):
        out.append(Finding(mod.path, node.lineno, "generator", msg))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        has_gen = kwarg(node, "generator") is not None
        if name in _LIKE_DRAWS:
            f(node, f"`{name}` draws from the global RNG — draw with an "
                    f"explicit torch.Generator")
        elif name in _GLOBAL_DRAWS:
            if not has_gen:
                f(node, f"`{name}` without generator= draws from the "
                        f"global RNG — pass an explicit torch.Generator")
        elif (isinstance(node.func, ast.Attribute) and not has_gen
              and node.func.attr in _INPLACE_DRAWS + _METHOD_DRAWS):
            f(node, f"`.{node.func.attr}(...)` without generator= draws "
                    f"from the global RNG — pass an explicit "
                    f"torch.Generator")

    # the key-collision class: one scope seeding two streams alike
    for scope in _scopes(mod):
        seen: Dict[tuple, int] = {}
        seeds = sorted((n for n in walk_skipping_defs(getattr(scope, "body",
                                                               []))
                        if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "manual_seed" and n.args),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in seeds:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                key = ("const", repr(arg.value))
            elif isinstance(arg, ast.Name):
                key = ("name", arg.id)
            else:
                continue
            if key in seen:
                f(node, f"`manual_seed({ast.unparse(arg)})` seeds a second "
                        f"stream alike in one scope (first at line "
                        f"{seen[key]}) — the two streams collide")
            else:
                seen[key] = node.lineno
    return sorted(out)


# --------------------------------------------------------------------------- #
# rule 3: in-place state handed to another thread
# --------------------------------------------------------------------------- #

_HANDOFF_METHODS = ("put", "put_nowait", "submit")


def _state_names(mod: LintModule) -> Set[str]:
    """The ``state=`` names of the module's ``EntrypointContract``s."""
    names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and ends(dotted(node.func),
                                               "EntrypointContract"):
            items = const_str_items(kwarg(node, "state")) \
                if kwarg(node, "state") is not None else None
            names.update(items or ())
    return names


def _is_clone(call: ast.Call) -> bool:
    """``x.clone()``, ``torch.clone(x)``, ``self._clone_actor()``,
    ``tree_map(torch.clone, x)``: the callee owns a fresh copy."""
    name = dotted(call.func) or ""
    if "clone" in name.rsplit(".", 1)[-1]:
        return True
    return any("clone" in (dotted(a) or "").rsplit(".", 1)[-1]
               for a in call.args)


def _state_refs(node, names: Set[str]) -> List[str]:
    """The references to a state name in ``node`` not under a clone."""
    if isinstance(node, ast.Call) and _is_clone(node):
        return []
    text = dotted(node) if isinstance(node, (ast.Name, ast.Attribute)) \
        else None
    if text is not None:
        parts = text.split(".")
        if parts[0] == "self":
            parts = parts[1:]
        return [text] if parts and parts[0] in names else []
    refs: List[str] = []
    for child in ast.iter_child_nodes(node):
        refs.extend(_state_refs(child, names))
    return refs


def check_inplace_alias(mod: LintModule, ctx: Context) -> List[Finding]:
    names = _state_names(mod)
    if not names:
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        handed: List[ast.AST] = []
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HANDOFF_METHODS):
            handed = list(node.args) + [kw.value for kw in node.keywords]
        elif ends(dotted(node.func), "Thread") and kwarg(node, "args"):
            handed = [kwarg(node, "args")]
        refs = [r for a in handed for r in _state_refs(a, names)]
        if refs:
            out.append(Finding(
                mod.path, node.lineno, "inplace-alias",
                f"in-place state `{refs[0]}` handed to another thread "
                f"without a clone — the next dispatch overwrites it while "
                f"the consumer reads it"))
    return out


# --------------------------------------------------------------------------- #
# rule 4: sharding axes
# --------------------------------------------------------------------------- #

_RULES_AXIS_KWARGS = ("batch", "seq", "fsdp", "tp", "ac")

# required shape of sharding.py's machine-checkable candidate-merge
# contract
_CONTRACT_NAME = "ALLGATHER_CANDIDATE_CONTRACT"
_CONTRACT_REQUIRED = {
    "axes_from": "batch_axes",
    "order": "row-major",
    "merge": "merge_topk_candidates",
}


def check_sharding(mod: LintModule, ctx: Context) -> List[Finding]:
    out: List[Finding] = []
    decl = is_mesh_decl_file(mod.path)

    def check_axes(node, items, what):
        for a in items or ():
            if a not in ctx.mesh_axes:
                out.append(Finding(
                    mod.path, node.lineno, "sharding-axes",
                    f"{what} axis {a!r} is not a declared mesh axis "
                    f"({sorted(ctx.mesh_axes)})"))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Subscript):
            base = node.value
            if (isinstance(base, ast.Attribute) and base.attr == "shape"
                    and ends(dotted(base.value), "mesh")):
                check_axes(node, const_str_items(node.slice),
                           "`mesh.shape[...]`")
            continue
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if ends(name, "MeshRules"):
            for kw in node.keywords:
                if kw.arg in _RULES_AXIS_KWARGS:
                    check_axes(node, const_str_items(kw.value),
                               f"`MeshRules({kw.arg}=)`")
        elif ends(name, "axis_size"):
            if node.args:
                check_axes(node, const_str_items(node.args[0]),
                           "`axis_size`")
        elif ends(name, "axis_index"):
            arg = node.args[1] if len(node.args) > 1 else kwarg(node,
                                                                "axis")
            if arg is not None:
                check_axes(node, const_str_items(arg), "`axis_index`")
        elif ends(name, "standard_rules", "spreeze_rules"):
            arg = kwarg(node, "data_axes")
            if arg is not None:
                check_axes(node, const_str_items(arg),
                           f"`{name}(data_axes=)`")
        elif ends(name, "param_spec"):
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    check_axes(node, [a.value], "`param_spec`")
        elif ends(name, "AxisMesh") and not decl and node.args \
                and isinstance(node.args[0], ast.Dict):
            check_axes(node, [k.value for k in node.args[0].keys
                              if isinstance(k, ast.Constant)
                              and isinstance(k.value, str)], "`AxisMesh`")

    # the candidate-merge ordering contract, machine-checkable
    if ctx.cfg.require_contract and is_contract_file(mod.path, ctx.cfg):
        out.extend(_check_merge_contract(mod))
    return out


def _check_merge_contract(mod: LintModule) -> List[Finding]:
    out: List[Finding] = []
    contract = None
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == _CONTRACT_NAME
                for t in node.targets):
            contract = node
    if contract is None:
        return [Finding(
            mod.path, 1, "sharding-axes",
            f"missing {_CONTRACT_NAME} annotation (the candidate-merge "
            f"order == batch_group_index row-major contract must be "
            f"machine-checkable)")]
    vals = {}
    if isinstance(contract.value, ast.Dict):
        for k, v in zip(contract.value.keys, contract.value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                vals[k.value] = v.value
    for k, want in _CONTRACT_REQUIRED.items():
        if vals.get(k) != want:
            out.append(Finding(
                mod.path, contract.lineno, "sharding-axes",
                f"{_CONTRACT_NAME}[{k!r}] must be {want!r} "
                f"(got {vals.get(k)!r})"))
    fns = {n.name: n for n in ast.walk(mod.tree)
           if isinstance(n, ast.FunctionDef)}
    for need in ("batch_axes", "batch_group_index"):
        if need not in fns:
            out.append(Finding(
                mod.path, contract.lineno, "sharding-axes",
                f"{_CONTRACT_NAME} names `{need}` but the module does not "
                f"define it"))
    bgi = fns.get("batch_group_index")
    if bgi is not None:
        has_axis_index = any(
            isinstance(n, ast.Call) and ends(dotted(n.func), "axis_index")
            for n in ast.walk(bgi))
        has_mul_acc = any(
            isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
            for n in ast.walk(bgi))
        if not (has_axis_index and has_mul_acc):
            out.append(Finding(
                mod.path, bgi.lineno, "sharding-axes",
                "batch_group_index no longer flattens row-major "
                "(idx * axis_size + axis_index) — the candidate-merge "
                "order contract is broken"))
    return out


# --------------------------------------------------------------------------- #
# rule 5: kernel launches
# --------------------------------------------------------------------------- #

_EXTENSION = "torch.ops.repro_torch."
_BUILD_CALLS = ("load_kernels", "cpp_extension.load", "load_inline")
_BUILD_IMPORTS = ("triton", "torch.utils.cpp_extension")


def _calls_extension(call: ast.Call) -> bool:
    return (dotted(call.func) or "").startswith(_EXTENSION)


def _bumps_launch_count(node) -> bool:
    return (isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Subscript)
            and ends(dotted(node.target.value), "LAUNCH_COUNTS"))


def _is_build_import(node) -> bool:
    if isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        base = node.module or ""
        mods = [base] + [f"{base}.{a.name}" for a in node.names]
    else:
        return False
    return any(m == b or m.startswith(b + ".") for m in mods
               for b in _BUILD_IMPORTS)


def check_kernel_launch(mod: LintModule, ctx: Context) -> List[Finding]:
    if not is_kernel_module(mod.path):
        return []
    if mod.is_cuda:
        return _check_shared_memory(mod)
    out: List[Finding] = []

    def f(node, msg):
        out.append(Finding(mod.path, node.lineno, "kernel-launch", msg))

    # counted launches: the extension's calls and LAUNCH_COUNTS' bumps in
    # the same function
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nodes = list(walk_skipping_defs(fn.body))
        launches = [n for n in nodes
                    if isinstance(n, ast.Call) and _calls_extension(n)]
        bumps = [n for n in nodes if _bumps_launch_count(n)]
        if launches and not bumps:
            f(launches[0], f"`{fn.name}` calls the built extension without "
                           f"bumping LAUNCH_COUNTS — a launch no run can "
                           f"count")
        if bumps and not launches:
            f(bumps[0], f"`{fn.name}` bumps LAUNCH_COUNTS without calling "
                        f"the built extension — a count with no launch")

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Try):
            if any(isinstance(n, ast.Call) and (
                    _calls_extension(n)
                    or ends(dotted(n.func), *_BUILD_CALLS))
                   for stmt in node.body for n in ast.walk(stmt)):
                f(node, "a `try` around a kernel's build or launch — a "
                        "kernel that fails must raise, never fall back")
        elif isinstance(node, (ast.If, ast.IfExp, ast.While)):
            if any(isinstance(n, ast.Call)
                   and ends(dotted(n.func), "is_available")
                   for n in ast.walk(node.test)):
                f(node, "an `is_available()` test picks a path — a "
                        "kernel's route is its operand's device "
                        "(kernels.pick), never what the machine has")

    # builds happen at first call, never at import
    for node in walk_skipping_defs(mod.tree.body):
        if _is_build_import(node):
            f(node, "a module-scope import of triton or of the build — "
                    "import it inside the function that launches the "
                    "kernel (the CPU imports every module)")
    return sorted(out)


_C_TYPE_BYTES = {"float": 4, "double": 8, "int": 4, "unsigned": 4,
                 "int32_t": 4, "uint32_t": 4, "int64_t": 8, "uint64_t": 8,
                 "int16_t": 2, "uint16_t": 2, "int8_t": 1, "uint8_t": 1,
                 "char": 1, "bool": 1, "half": 2, "__half": 2,
                 "__nv_bfloat16": 2, "float2": 8, "float4": 16,
                 "int2": 8, "int4": 16, "uint2": 8, "uint4": 16,
                 "size_t": 8, "long": 8}
_CONSTEXPR_RE = re.compile(
    r"constexpr\s+(?:static\s+)?(?:unsigned\s+)?(?:int|long|size_t|int32_t|"
    r"uint32_t|int64_t|uint64_t)\s+(\w+)\s*=\s*([^;]+);")
_STATIC_SHARED_RE = re.compile(
    r"^\s*(?:static\s+)?__shared__\s+(?:__align__\(\d+\)\s+)?"
    r"(?:unsigned\s+)?(\w+)\s+(\w+)((?:\s*\[[^\]]+\])+)\s*;")
_DYNAMIC_ATTR_RE = re.compile(
    r"cudaFuncAttributeMaxDynamicSharedMemorySize\s*,\s*([^)]+)\)")
_LAUNCH_SMEM_RE = re.compile(r"<<<\s*[^,>]+,\s*[^,>]+,\s*([^,>]+)")
_ARITH_RE = re.compile(r"^[\s0-9a-zA-Z_+\-*/()<>%]+$")


def _c_eval(expr: str, consts: Dict[str, int]) -> Optional[int]:
    """An integer C expression of literals and the file's ``constexpr``
    ints, or None when it holds anything else."""
    expr = re.sub(r"(\d+)[uUlL]+\b", r"\1", expr.strip())
    if not _ARITH_RE.match(expr) or re.search(r"(?<![<>])[<>](?![<>])",
                                              expr):
        return None
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    if not names <= set(consts):
        return None
    try:
        val = eval(expr.replace("/", "//"),  # noqa: S307
                   {"__builtins__": {}}, dict(consts))
    except Exception:
        return None
    return val if isinstance(val, int) else None


def _check_shared_memory(mod: LintModule) -> List[Finding]:
    """Literal shared-memory sizes of a CUDA source against a Hopper
    block's budgets."""
    text = "\n".join(mod.lines)
    consts: Dict[str, int] = {}
    for m in _CONSTEXPR_RE.finditer(text):
        val = _c_eval(m.group(2), consts)
        if val is not None:
            consts[m.group(1)] = val
    out: List[Finding] = []
    static, dynamic = SMEM_STATIC_BYTES, SMEM_DYNAMIC_BYTES
    for i, line in enumerate(mod.lines, start=1):
        m = _STATIC_SHARED_RE.match(line)
        if m and m.group(1) in _C_TYPE_BYTES:
            size = _C_TYPE_BYTES[m.group(1)]
            for dim in re.findall(r"\[([^\]]+)\]", m.group(3)):
                val = _c_eval(dim, consts)
                size = None if val is None or size is None else size * val
            if size is not None and size > static:
                out.append(Finding(
                    mod.path, i, "kernel-launch",
                    f"static __shared__ `{m.group(2)}` of {size} bytes "
                    f"exceeds the {static}-byte static budget of a block"))
    for pattern, what in ((_DYNAMIC_ATTR_RE, "a dynamic shared-memory "
                           "attribute"), (_LAUNCH_SMEM_RE, "a launch's "
                                          "dynamic shared memory")):
        for dm in pattern.finditer(text):
            val = _c_eval(dm.group(1), consts)
            if val is not None and val > dynamic:
                out.append(Finding(
                    mod.path, text.count("\n", 0, dm.start()) + 1,
                    "kernel-launch",
                    f"{what} of {val} bytes exceeds the {dynamic}-byte "
                    f"budget of a Hopper block"))
    return sorted(out)


# --------------------------------------------------------------------------- #
# rule 6: process-wide settings
# --------------------------------------------------------------------------- #

_CONFIG_CALLS = ("torch.set_float32_matmul_precision",
                 "torch.set_default_dtype", "torch.set_default_device",
                 "torch.set_default_tensor_type",
                 "torch.use_deterministic_algorithms",
                 "torch.cuda.set_sync_debug_mode")
_ENV_CALLS = ("os.environ.setdefault", "os.environ.update",
              "os.environ.pop", "os.environ.clear", "os.putenv",
              "os.unsetenv")


def check_config(mod: LintModule, ctx: Context) -> List[Finding]:
    if is_config_file(mod.path, ctx.cfg):
        return []
    out: List[Finding] = []

    def f(node, what):
        out.append(Finding(
            mod.path, node.lineno, "config-mutation",
            f"{what} outside repro_torch/__init__.py — a process-wide "
            f"setting must have exactly one owner"))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in _CONFIG_CALLS or name in _ENV_CALLS:
                f(node, f"`{name}`")
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                if (dotted(t) or "").startswith("torch.backends."):
                    f(node, f"`{dotted(t)} = ...`")
                elif isinstance(t, ast.Subscript) and \
                        dotted(t.value) == "os.environ":
                    f(node, "an `os.environ[...]` write")
    return out


ALL_RULES = (check_host_transfer, check_generator, check_inplace_alias,
             check_sharding, check_kernel_launch, check_config)
