"""The port's tracelint: the fixture corpus (a bad and a good file for each
rule family, with exact (line, rule) findings), suppressions, the
baseline round trip and staleness, the candidate-merge contract, CLI exit
codes, parity with the reference's engine on the same text, and the
standing invariant that ``src/repro_torch`` is clean against
``tracelint-torch-baseline.txt``."""
import os
import textwrap

import pytest

from repro.analysis.tracelint import engine as ref_engine
from repro_torch.analysis.tracelint import engine
from repro_torch.analysis.tracelint.cli import main as cli_main
from repro_torch.analysis.tracelint.config import LintConfig

FIXTURES = os.path.join("tests", "torch_tracelint_fixtures")
KERNELS = "repro_torch/kernels/"
NO_CONTRACT = LintConfig(require_contract=False)


def _findings(path, cfg=NO_CONTRACT):
    findings, stale, _ = engine.run([path], cfg=cfg)
    assert not stale
    return findings


def _locs(findings):
    return [(f.path.rsplit("/", 1)[-1], f.line, f.rule) for f in findings]


# --------------------------------------------------------------------------- #
# the fixture corpus: exact findings a family
# --------------------------------------------------------------------------- #

BAD_EXPECT = {
    KERNELS + "bad_host_transfer.py": [
        (9, "host-transfer"),            # .item()
        (10, "host-transfer"),           # .tolist()
        (11, "host-transfer"),           # .cpu()
        (12, "host-transfer"),           # float(tensor)
        (13, "host-transfer"),           # int(tensor)
        (14, "host-transfer"),           # bool(tensor)
        (16, "host-transfer"),           # torch.cuda.synchronize()
        (17, "host-transfer"),           # Event.synchronize()
        (18, "host-transfer"),           # np.asarray(tensor)
    ],
    "bad_generator.py": [
        (6, "generator"),                # torch.randn, no generator
        (7, "generator"),                # torch.rand_like
        (8, "generator"),                # Tensor.normal_, no generator
        (10, "generator"),               # manual_seed(seed) twice
        (11, "generator"),               # torch.randint, no generator
        (17, "generator"),               # manual_seed(0) twice
    ],
    "bad_inplace_alias.py": [
        (14, "inplace-alias"),           # q.put(self.state.actor)
        (15, "inplace-alias"),           # pool.submit(..., self.replay)
        (16, "inplace-alias"),           # Thread(args=(self.state,))
    ],
    "bad_sharding.py": [
        (6, "sharding-axes"), (7, "sharding-axes"), (8, "sharding-axes"),
        (9, "sharding-axes"), (10, "sharding-axes"),
    ],
    KERNELS + "bad_kernel_launch.py": [
        (5, "kernel-launch"),            # module-scope import triton
        (13, "kernel-launch"),           # a launch not counted
        (17, "kernel-launch"),           # a count with no launch
        (22, "kernel-launch"),           # try around a launch: a fallback
        (32, "kernel-launch"),           # is_available() picks a path
    ],
    KERNELS + "csrc/bad_smem.cu": [
        (11, "kernel-launch"),           # 256 KB static __shared__
        (17, "kernel-launch"),           # 300 KB dynamic attribute
    ],
    "bad_config.py": [
        (6, "config-mutation"), (7, "config-mutation"),
        (8, "config-mutation"), (9, "config-mutation"),
        (10, "config-mutation"), (11, "config-mutation"),
    ],
    "bad_suppression.py": [
        (6, "suppression"),
    ],
}

GOOD_FILES = ["good_generator.py", "good_inplace_alias.py",
              "good_sharding.py", KERNELS + "good_host_transfer.py",
              KERNELS + "good_kernel_launch.py"]


@pytest.mark.parametrize("name", sorted(BAD_EXPECT))
def test_bad_fixture_exact_findings(name):
    findings = _findings(os.path.join(FIXTURES, name))
    base = name.rsplit("/", 1)[-1]
    assert _locs(findings) == [(base, ln, rule)
                               for ln, rule in BAD_EXPECT[name]]


@pytest.mark.parametrize("name", GOOD_FILES)
def test_good_fixture_clean(name):
    assert _findings(os.path.join(FIXTURES, name)) == []


def test_corpus_total_and_every_family_fires():
    """The whole corpus agrees with the per-file sums, and each family
    fires somewhere."""
    findings = _findings(FIXTURES)
    assert len(findings) == sum(map(len, BAD_EXPECT.values()))
    assert all(f.path.rsplit("/", 1)[-1].startswith("bad_")
               for f in findings)
    assert {f.rule for f in findings} == set(engine.RULES)


# --------------------------------------------------------------------------- #
# suppressions
# --------------------------------------------------------------------------- #

def _hot(tmp_path, text, name="hot.py"):
    f = tmp_path / "repro_torch" / "kernels" / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(text))
    return f


def test_inline_allow_with_reason_suppresses(tmp_path):
    f = _hot(tmp_path, """\
        import torch
        def g(x):
            # tracelint: allow[host-transfer] -- measured handoff
            torch.cuda.synchronize()
            return x.item()  # tracelint: allow[host-transfer] -- result fetch
    """)
    assert _findings(str(f)) == []


def test_adjacent_suppressions_merge(tmp_path):
    """A comment-line suppression and the covered line's own suppression
    union their rule sets."""
    f = _hot(tmp_path, """\
        import torch
        def g(x):
            # tracelint: allow[host-transfer] -- measured handoff
            return x.item(), torch.randn(2)  # tracelint: allow[generator] -- a fixture draw
    """)
    assert _findings(str(f)) == []


def test_allow_wrong_rule_does_not_suppress(tmp_path):
    f = _hot(tmp_path, "def g(x):\n"
                       "    return x.item()"
                       "  # tracelint: allow[generator] -- wrong family\n")
    [fd] = _findings(str(f))
    assert fd.rule == "host-transfer" and fd.line == 2


def test_cuda_allow_uses_a_cuda_comment(tmp_path):
    """In a CUDA source the allow is a ``//`` comment; a ``#`` one (a
    preprocessor line) is not read."""
    d = tmp_path / "repro_torch" / "kernels" / "csrc"
    d.mkdir(parents=True)
    f = d / "k.cu"
    f.write_text("__global__ void k(float* o) {\n"
                 "  __shared__ float big[65536];  // tracelint: "
                 "allow[kernel-launch] -- a fixture\n"
                 "  __shared__ float big2[65536];\n"
                 "}\n")
    assert _locs(_findings(str(f))) == [("k.cu", 3, "kernel-launch")]


# --------------------------------------------------------------------------- #
# baseline round trip and staleness
# --------------------------------------------------------------------------- #

_DIRTY = "import torch\ntorch.set_default_dtype(torch.float64)\n"


def test_baseline_roundtrip_and_staleness(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(_DIRTY)
    baseline = tmp_path / "baseline.txt"

    findings, stale, modules = engine.run([str(f)], cfg=NO_CONTRACT)
    assert [fd.rule for fd in findings] == ["config-mutation"]
    engine.write_baseline(str(baseline), findings, modules, "known debt")

    findings, stale, _ = engine.run([str(f)], cfg=NO_CONTRACT,
                                    baseline_path=str(baseline))
    assert findings == [] and stale == []

    # the line moves: the entry is stale and the finding is back
    f.write_text("import torch\n\ntorch.set_default_dtype(torch.float64)\n")
    findings, stale, _ = engine.run([str(f)], cfg=NO_CONTRACT,
                                    baseline_path=str(baseline))
    assert len(stale) == 1 and "stale" in stale[0]
    assert [fd.line for fd in findings] == [3]


def test_write_baseline_preserves_valid_entries(tmp_path):
    a = tmp_path / "a.py"
    a.write_text(_DIRTY)
    baseline = tmp_path / "baseline.txt"
    assert cli_main([str(a), "--baseline", str(baseline), "--no-contract",
                     "--write-baseline", "--reason", "curated: a"]) == 0
    b = tmp_path / "b.py"
    b.write_text("import os\nos.environ['X'] = '1'\n")
    assert cli_main([str(a), str(b), "--baseline", str(baseline),
                     "--no-contract", "--write-baseline",
                     "--reason", "new debt"]) == 0
    by_file = {e.path.rsplit("/", 1)[-1]: e
               for e in engine.load_baseline(str(baseline))}
    assert by_file["a.py"].reason == "curated: a"
    assert by_file["b.py"].reason == "new debt"
    assert cli_main([str(a), str(b), "--baseline", str(baseline),
                     "--no-contract"]) == 0


def test_baseline_rejects_malformed(tmp_path):
    b = tmp_path / "baseline.txt"
    b.write_text("config-mutation | not-a-location | reason | src\n")
    with pytest.raises(ValueError):
        engine.load_baseline(str(b))


# --------------------------------------------------------------------------- #
# parity with the reference's engine on the same text
# --------------------------------------------------------------------------- #

_SUPPRESSED = textwrap.dedent("""\
    import torch
    # tracelint: allow[host-transfer, generator] -- two families
    x = 1
    y = 2  # tracelint: allow[*] -- every family
    # tracelint: allow[host-transfer]
    z = 3  # tracelint: allow[config-mutation] -- merged with the bare one
    w = 4  # tracelint: allow[prng-reuse]-- no space before the reason
""")


def test_suppression_parsing_matches_the_reference():
    lines = _SUPPRESSED.splitlines()
    ours = engine.parse_suppressions(engine.LintModule("m.py", None, lines))
    theirs = ref_engine.parse_suppressions(
        ref_engine.LintModule("m.py", None, lines))
    assert ours == theirs and len(ours) == 6


def test_baseline_load_and_staleness_match_the_reference(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("a = 1\nb = 2\nc = 3\n")
    rel = os.path.relpath(str(f)).replace(os.sep, "/")
    b = tmp_path / "baseline.txt"
    b.write_text("# header\n\n"
                 f"host-transfer | {rel}:1 | fine | a = 1\n"
                 f"generator | {rel}:2 | moved | b = 20\n"
                 f"config-mutation | {rel}:9 | gone | x\n")
    ours, theirs = engine.load_baseline(str(b)), ref_engine.load_baseline(
        str(b))
    assert [e.format() for e in ours] == [e.format() for e in theirs]
    lines = f.read_text().splitlines()
    ours_stale = engine.check_baseline(
        ours, {rel: engine.LintModule(rel, None, lines)})
    theirs_stale = ref_engine.check_baseline(
        theirs, {rel: ref_engine.LintModule(rel, None, lines)})
    assert ours_stale == theirs_stale and len(ours_stale) == 2


# --------------------------------------------------------------------------- #
# the candidate-merge contract of distributed/sharding.py
# --------------------------------------------------------------------------- #

def test_contract_annotation_required(tmp_path):
    d = tmp_path / "distributed"
    d.mkdir()
    f = d / "sharding.py"
    f.write_text("def batch_axes(rules):\n    return ()\n")
    findings, _, _ = engine.run([str(f)], cfg=LintConfig())
    assert any(f0.rule == "sharding-axes" and
               "ALLGATHER_CANDIDATE_CONTRACT" in f0.msg for f0 in findings)


def test_contract_row_major_required(tmp_path):
    d = tmp_path / "distributed"
    d.mkdir()
    f = d / "sharding.py"
    f.write_text(textwrap.dedent("""\
        ALLGATHER_CANDIDATE_CONTRACT = {
            "axes_from": "batch_axes",
            "order": "row-major",
            "merge": "merge_topk_candidates",
        }
        def batch_axes(rules):
            return ()
        def batch_group_index(rules, ac=0, batch=0):
            return ac + batch
    """))
    findings, _, _ = engine.run([str(f)], cfg=LintConfig())
    assert [f0.line for f0 in findings] == [8]
    assert "row-major" in findings[0].msg


# --------------------------------------------------------------------------- #
# the standing invariant + CLI exit codes
# --------------------------------------------------------------------------- #

def test_port_is_clean_against_checked_in_baseline():
    """The gate, as a test: ``src/repro_torch`` has no finding outside
    ``tracelint-torch-baseline.txt`` and no stale entry in it."""
    findings, stale, modules = engine.run(
        ["src/repro_torch"], baseline_path="tracelint-torch-baseline.txt")
    assert stale == [], stale
    assert findings == [], [f.format() for f in findings]
    assert any(p.endswith(".cu") for p in modules)   # the sources too


def test_cli_default_path_exits_clean(capsys):
    assert cli_main([]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text(_DIRTY)
    assert cli_main([str(clean), "--baseline", "", "--no-contract"]) == 0
    assert cli_main([str(dirty), "--baseline", "", "--no-contract"]) == 1
    b = tmp_path / "baseline.txt"
    assert cli_main([str(dirty), "--baseline", str(b), "--no-contract",
                     "--write-baseline", "--reason", "fixture debt"]) == 0
    assert cli_main([str(dirty), "--baseline", str(b),
                     "--no-contract"]) == 0
    dirty.write_text("import torch\n\n"
                     "torch.set_default_dtype(torch.float64)\n")
    assert cli_main([str(dirty), "--baseline", str(b),
                     "--no-contract"]) == 2      # stale entry
    b.write_text("garbage | no-line | x | y\n")
    assert cli_main([str(dirty), "--baseline", str(b),
                     "--no-contract"]) == 2      # malformed baseline
    capsys.readouterr()
