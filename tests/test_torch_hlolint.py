"""The port's hlolint: the contract language (and its parity with the
reference's on hypothesis-drawn expressions and shapes), the checks on
canned inputs, the coverage scan, the fixture corpus through the CLI
(every family fires, the control stays silent), the port's own contracts
on the CPU, and the registries: every contract has a builder and an
annotation, and every one of the reference's contracts has its port."""
import collections
import os

import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hyp_fallback import given, settings, strategies as st

from repro.analysis.hlolint import checks as ref_checks
from repro.analysis.hlolint import contract as ref_contract
from repro_torch.analysis.hlolint import checks, cli, coverage, entrypoints
from repro_torch.analysis.hlolint.contract import (MOVE, CollectiveContract,
                                                   CollectiveRule,
                                                   EntrypointContract,
                                                   eval_dim)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "torch_hlolint_fixtures", "fixtures.py")


# --------------------------------------------------------------------------- #
# the contract language
# --------------------------------------------------------------------------- #

def test_eval_dim():
    assert eval_dim("4", {}) == 4
    assert eval_dim("groups*k", {"groups": 4, "k": 64}) == 256
    assert eval_dim("batch//groups", {"batch": 64, "groups": 4}) == 16
    assert eval_dim("4*layers+1", {"layers": 24}) == 97
    with pytest.raises(ValueError):            # unknown symbol
        eval_dim("capacity", {})
    with pytest.raises(ValueError):            # non-integral: / not //
        eval_dim("batch/groups", {"batch": 3, "groups": 2})
    with pytest.raises(ValueError):            # charset rejection
        eval_dim("__import__('os')", {})


def test_collective_contract_check_order():
    """Rule matching first, then the cap: a cap-exempt rule admits a
    parameter-shaped move larger than the cap, a matched non-exempt one
    at the cap fails, an unmatched one is reported as such."""
    p = {"capacity": 1024, "hidden": 256}
    c = CollectiveContract(
        allow=(CollectiveRule(MOVE, ("hidden", "hidden"), cap_exempt=True),
               CollectiveRule(MOVE, ("capacity",))),
        max_elems="capacity")
    assert CollectiveContract(max_elems="capacity").check(
        [(MOVE, ())], p) == []
    assert c.check([(MOVE, (256, 256))], p) == []
    bad = c.check([(MOVE, (1024,))], p)
    assert len(bad) == 1 and "max_elems" in bad[0][2]
    bad = c.check([(MOVE, (8,))], p)
    assert len(bad) == 1 and bad[0][2] == "matches no allow rule"


_SYMBOLS = ("batch", "groups", "k", "capacity")
_OPS = ("+", "-", "*", "//", "%")


def _expr(parts):
    """A dim expression from drawn (symbol-or-int, op) pairs."""
    out = []
    for i, (atom, op) in enumerate(parts):
        out.append(str(atom))
        if i + 1 < len(parts):
            out.append(op)
    return "".join(out)


_pairs = st.lists(st.sampled_from([(a, o) for a in list(_SYMBOLS)
                                   + [1, 2, 3, 7, 16] for o in _OPS]),
                  min_size=1, max_size=4)
_dims = st.lists(st.integers(min_value=0, max_value=70), min_size=0,
                 max_size=4)
_rule_dims = st.lists(st.sampled_from(["*", "batch", "groups*k",
                                       "batch//groups", "capacity", "4",
                                       "k+1"]), min_size=0, max_size=3)


def _params(batch, groups):
    return {"batch": batch, "groups": groups, "k": batch // groups,
            "capacity": 64}


def _same(fn_ours, fn_ref):
    """Both results, or both exceptions of one type."""
    try:
        ours = ("ok", fn_ours())
    except Exception as e:
        ours = ("raise", type(e))
    try:
        ref = ("ok", fn_ref())
    except Exception as e:
        ref = ("raise", type(e))
    assert ours == ref


@settings(max_examples=60, deadline=None)
@given(parts=_pairs, batch=st.integers(min_value=1, max_value=64),
       groups=st.sampled_from([1, 2, 4, 8]))
def test_eval_dim_matches_the_reference(parts, batch, groups):
    expr, p = _expr(parts), _params(batch, groups)
    _same(lambda: eval_dim(expr, p), lambda: ref_contract.eval_dim(expr, p))


@settings(max_examples=60, deadline=None)
@given(dims=_rule_dims, tail=st.sampled_from([False, True]), shape=_dims,
       exempt=st.sampled_from([False, True]),
       batch=st.sampled_from([8, 16, 64]),
       groups=st.sampled_from([1, 2, 4]))
def test_rules_and_contracts_match_the_reference(dims, tail, shape, exempt,
                                                 batch, groups):
    p = _params(batch, groups)
    rule_dims = tuple(dims) + (("...",) if tail else ())
    ours = CollectiveRule(MOVE, rule_dims, cap_exempt=exempt)
    ref = ref_contract.CollectiveRule("all-gather", rule_dims,
                                      cap_exempt=exempt)
    _same(lambda: ours.matches(MOVE, tuple(shape), p),
          lambda: ref.matches("all-gather", tuple(shape), p))
    ours_c = CollectiveContract(allow=(ours,), max_elems="capacity")
    ref_c = ref_contract.CollectiveContract(allow=(ref,),
                                            max_elems="capacity")
    _same(lambda: [why for _, _, why in ours_c.check(
              [(MOVE, tuple(shape))], p)],
          lambda: [why for _, _, why in ref_c.check(
              [("all-gather", tuple(shape))], p)])


def test_capacity_offenders_and_shape_delta_match_the_reference():
    per = [("all-gather", (256,)), ("all-gather", (256,)),
           ("all-reduce", (16,)), ("all-gather", (4096,)),
           ("to_group", (1024, 3))]
    base = [("all-gather", (256,)), ("all-reduce", (16,))]
    added = checks.shape_delta(per, base)
    assert sorted(added) == sorted(ref_checks.shape_delta(per, base))
    assert sorted(added) == [("all-gather", [256]), ("all-gather", [4096]),
                             ("to_group", [1024, 3])]
    for cap in (256, 3072, 4096, 10**6):
        assert (checks.capacity_offenders(added, cap)
                == ref_checks.capacity_offenders(added, cap))


# --------------------------------------------------------------------------- #
# the checks on canned inputs
# --------------------------------------------------------------------------- #

def test_check_inplace():
    c = EntrypointContract(name="e", module="m", inplace=True,
                           state=("s",), min_inplace_fraction=0.5)
    before = {("s", 0): 10, ("s", 1): 20}
    assert checks.check_inplace(c, before, {("s", 0): 10,
                                            ("s", 1): 99}) == []
    [f] = checks.check_inplace(c, before, {("s", 0): 11, ("s", 1): 99})
    assert f.rule == "inplace" and "0/2" in f.msg
    assert checks.check_inplace(EntrypointContract(name="e", module="m"),
                                before, {}) == []
    [f] = checks.check_inplace(c, {}, {})
    assert "no tensor leaves" in f.msg


def test_check_dtypes_bans_float64_everywhere():
    c = EntrypointContract(name="e", module="m",
                           float_dtypes=("float32", "bfloat16", "float64"))
    found = checks.check_dtypes(c, {"float64": 2, "bfloat16": 3, "int32": 9})
    assert len(found) == 1 and "banned" in found[0].msg
    found = checks.check_dtypes(EntrypointContract(name="e", module="m"),
                                {"float16": 1, "bool": 4})
    assert [f.rule for f in found] == ["dtype"] and "float16" in found[0].msg


def test_check_host_reads():
    c = EntrypointContract(name="e", module="m")
    reads = collections.Counter({"item/float/int/bool": 2})
    [f] = checks.check_host_reads(c, reads, None)
    assert f.rule == "host-read" and "x2" in f.msg
    sync = RuntimeError("called a synchronizing CUDA operation")
    assert len(checks.check_host_reads(c, collections.Counter(), sync)) == 1
    cold = EntrypointContract(name="e", module="m", hot=False)
    assert checks.check_host_reads(cold, reads, sync) == []


def test_check_launches():
    c = EntrypointContract(name="e", module="m",
                           launches={"ring_gather": "updates*groups"})
    p = {"updates": 2, "groups": 4}
    good = [{"ring_gather": 8}] * 3
    assert checks.check_launches(c, p, good, [10, 10, 10], good,
                                 [1, 1, 1]) == []
    found = checks.check_launches(c, p, [{"ring_gather": 8, "per_topk": 1}],
                                  [10, 11], [{"ring_gather": 7}], [1, 2])
    msgs = " | ".join(f.msg for f in found)
    assert all(f.rule == "launches" for f in found) and len(found) == 4
    assert "per_topk: 1 calls" in msgs and "LAUNCH_COUNTS" in msgs
    assert "vary" in msgs and "rebuilt" in msgs
    broken = EntrypointContract(name="e", module="m",
                                launches={"rmsnorm": "layers"})
    [f] = checks.check_launches(broken, {}, [{}], [1])
    assert f.rule == "contract-error"


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_host_reads_are_seen_on_cpu_and_meta(dev):
    reads = checks._HostReads()
    x = torch.ones(3, device=dev)
    with reads:
        for read in (lambda: bool(x.sum() > 0), lambda: x.sum().item()):
            try:
                read()
            except RuntimeError:       # meta: no value to read
                assert dev == "meta"
        if dev == "cpu":
            torch.equal(x, x)
            x.nonzero()
            x.add(1)                   # no read
    want = {"item/float/int/bool": 2}
    if dev == "cpu":
        want.update({"equal": 1, "nonzero (its size)": 1})
    assert dict(reads.reads) == want


# --------------------------------------------------------------------------- #
# the coverage scan
# --------------------------------------------------------------------------- #

def test_coverage_scan(tmp_path):
    src = (
        "from repro_torch.kernels import ops as kops\n"           # 1
        "\n"                                                      # 2
        "# hlolint: entrypoint[known]\n"                          # 3
        "def covered(p, r, ptr):\n"                               # 4
        "    kops.ring_write_fields(p, r, ptr)\n"                 # 5
        "def bare(p, r, ptr):\n"                                  # 6
        "    kops.ring_write_fields(p, r, ptr)\n"                 # 7
        "def step(opt, g, s, p):\n"                               # 8
        "    opt.update(g, s, p)\n"                               # 9
        "    {}.update({})\n"                                     # 10
        "# hlolint: exempt\n"                                     # 11
        "def noreason(pri, i, v):\n"                              # 12
        "    kops.priority_scatter(pri, i, v)\n"                  # 13
        "# hlolint: exempt -- checked by its caller's contract\n"  # 14
        "def fine(pri, i, v):\n"                                  # 15
        "    def inner():\n"                                      # 16
        "        kops.priority_scatter(pri, i, v)\n"              # 17
        "    return inner\n"                                      # 18
        "# hlolint: entrypoint[ghost]\n"                          # 19
        "def unknown():\n"                                        # 20
        "    pass\n"                                              # 21
        "x = 1  # hlolint: entrypoint[known]\n"                   # 22
        "'''# hlolint: entrypoint[in_a_docstring]'''\n")          # 23
    p = tmp_path / "mod.py"
    p.write_text(src)
    found = coverage.scan_file(str(p), "mod.py", known_names=["known"],
                               hot=True)
    locs = sorted((f.entrypoint, f.rule) for f in found)
    assert locs == [("mod.py:11", "coverage"),        # exempt w/o reason
                    ("mod.py:19", "contract-error"),  # 'ghost' undeclared
                    ("mod.py:22", "coverage"),        # not at a def
                    ("mod.py:7", "coverage"),         # bare ring write
                    ("mod.py:9", "coverage")]         # optimizer update
    # not a hot module: only the annotations are checked
    cold = coverage.scan_file(str(p), "mod.py", known_names=["known"],
                              hot=False)
    assert sorted(f.entrypoint for f in cold) == ["mod.py:11", "mod.py:19",
                                                  "mod.py:22"]


def test_port_is_fully_covered():
    """Every in-place hot site of the port carries a contract or a reasoned
    exempt, and every contract is annotated at exactly one def."""
    known = [c.name for c in entrypoints.collect_contracts()]
    found = coverage.scan_tree(os.path.join(ROOT, "src", "repro_torch"),
                               known)
    assert found == [], "\n".join(f.format() for f in found)


def test_contract_builder_registries_agree():
    names = [c.name for c in entrypoints.collect_contracts()]
    assert len(names) == len(set(names)), "duplicate contract names"
    assert set(names) == set(entrypoints.BUILDERS)


def test_every_reference_contract_has_a_port():
    from repro.analysis.hlolint import entrypoints as ref_entrypoints
    ref = {c.name: c for c in ref_entrypoints.collect_contracts()}
    ours = {c.name: c for c in entrypoints.collect_contracts()}
    # the port adds one contract of its own: its rotary-embedding kernel
    # (the reference rotates in jnp, with no entry point to guard)
    assert len(ref) == 12 and set(ours) == set(ref) | {"rope"}
    for name, c in ref.items():
        # a donated reference entry point is an in-place one here, but the
        # sampler: the port's env states are made anew every step
        assert ours[name].inplace == (c.donates and name != "sampler_chunk")
        assert ours[name].module == c.module.replace("repro.",
                                                     "repro_torch.", 1)


# --------------------------------------------------------------------------- #
# the CLI: the fixture corpus and the port
# --------------------------------------------------------------------------- #

def _uncovered_fixture_line() -> int:
    with open(os.path.join(ROOT, FIXTURES)) as f:
        for i, line in enumerate(f, 1):
            if "return kops.ring_write_fields(pools, rows, ptr)" in line:
                return i
    raise AssertionError("coverage fixture site not found")


def test_fixture_corpus_fires_every_family(capsys):
    assert cli.main(["--device", "cpu", "--fixtures", FIXTURES, "-q"]) == 1
    out = capsys.readouterr().out
    assert "[contract-error]" not in out
    for ent, rule in [("bad_inplace", "inplace"),
                      ("bad_collective", "collective"),
                      ("bad_dtype", "dtype"),
                      ("bad_host_read", "host-read"),
                      ("bad_launches", "launches")]:
        assert f"{ent}: [{rule}]" in out, f"{ent} missing:\n{out}"
    line = _uncovered_fixture_line()
    assert (f"tests/torch_hlolint_fixtures/fixtures.py:{line}: [coverage]"
            in out), out
    assert "good_entry:" not in out


def test_a_broken_contract_exits_2(tmp_path, capsys):
    f = tmp_path / "broken.py"
    f.write_text(
        "from repro_torch.analysis.hlolint.contract import "
        "EntrypointContract\n"
        "HLOLINT_CONTRACTS = (\n"
        "    EntrypointContract(name='typo', module=__name__,\n"
        "                       launches={'rmsnorm': 'layerz'}),\n"
        "    EntrypointContract(name='orphan', module=__name__),\n"
        ")\n"
        "# hlolint: entrypoint[typo]\n"
        "def _typo(device, census):\n"
        "    return {'dispatch': lambda: None, 'state': dict,\n"
        "            'params': {'layers': 2}}\n"
        "BUILDERS = {'typo': _typo}\n")
    assert cli.main(["--device", "cpu", "--fixtures", str(f), "-q"]) == 2
    out = capsys.readouterr().out
    assert "orphan: [contract-error] no builder" in out
    assert "typo: [contract-error]" in out and "layerz" in out


def test_default_device_is_the_card(monkeypatch):
    """Without a card the default run raises rather than running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-q"])


def test_port_contracts_hold_on_the_cpu(capsys):
    """``python -m repro_torch.analysis.hlolint --device cpu``: every
    contract of the port holds, and each report's kernel calls per
    dispatch are its contract's."""
    assert cli.main(["--device", "cpu"]) == 0, capsys.readouterr().out
    out = capsys.readouterr().out
    assert "[hlolint] clean (13 contracts)" in out
    assert "megastep_sharded_per: ops/dispatch" in out
