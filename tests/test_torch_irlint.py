"""The port's IR-level checks (``repro_torch.analysis.irlint``), mirroring
``tests/test_irlint.py``.

* Each rule's check against the reference's on the same inputs: the
  prefill bucket sweep (as shipped and with both packages' bucketing
  broken the same way), the serve-dtype check, the donation and host-sync
  checks, the contract comparison and the stale entries on the same
  measured and contract dicts: the same findings (rule, severity, the
  offending item, the target) and the same constants.
* Injected faults exit 1 through the CLI: an un-kept donation, a host
  sync, a doctored contract, a ptxas log over the card's shared memory.
* The tiny targets traced for real, in a subprocess with its own timeout
  (the dry run's fake process group must not live in a test worker): clean
  against the committed contract file, round-tripped through
  ``--write-contracts``; a doctored contract, an optimizer step that
  allocates new parameters and an ``.item()`` inside ``decode_scan`` each
  exit 1.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import irlint as jir  # noqa: E402
from repro_torch.analysis import contracts, irlint  # noqa: E402
from repro_torch.analysis.irlint import DonatedLeaf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mt(mod, **kw):
    base = dict(key="tiny|decode_tiny|4x2", arch="tiny", shape="decode_tiny",
                mesh="4x2", kind="decode", path="src/x.py", line=1, chips=8)
    base.update(kw)
    return mod.MeasuredTarget(**base)


def _keys(findings):
    return [(f.rule, f.severity, f.src_line, f.context) for f in findings]


# -- constants and targets ---------------------------------------------------


def test_constants_and_targets_are_the_references():
    for name in ("MIN_ALIAS_BYTES", "CONTRACT_REL_TOL", "CONTRACT_ABS_TOL",
                 "COLLECTIVE_KINDS"):
        assert getattr(irlint, name) == getattr(jir, name), name
    with open(os.path.join(ROOT, "lowering_contracts.json")) as f:
        ref = json.load(f)["entries"]
    assert sorted(t.key for t in contracts.default_targets()) == sorted(ref)
    assert [t.key for t in contracts.default_targets(["tiny"])] == [
        "tiny|train_tiny|4x2", "tiny|prefill_tiny|4x2",
        "tiny|decode_tiny|4x2", "tiny|weight_sync|4x2"]


def test_committed_contract_file_holds_every_target():
    entries = contracts.load_contracts(contracts.CONTRACTS_DEFAULT)
    assert sorted(entries) == sorted(t.key
                                     for t in contracts.default_targets())
    for key, e in entries.items():
        assert set(e["collective_bytes"]) == set(irlint.COLLECTIVE_KINDS)
        assert e["donated_leaves"] == e["aliased_leaves"], key
        assert e["chips"] == (8 if key.startswith("tiny") else 256)


# -- IR401 --------------------------------------------------------------------


def test_bucket_sweep_clean_as_the_reference():
    assert irlint.check_bucket_stability() == []
    assert jir.check_bucket_stability() == []


@pytest.mark.parametrize("broken", ["no_length_round", "no_row_round"])
def test_bucket_sweep_broken_gives_the_references_findings(monkeypatch,
                                                           broken):
    from repro.core import rollout as jro
    from repro_torch.core import rollout as tro

    def pad(lens, rows, pending):
        if broken == "no_length_round":
            return max(lens), rows, pending
        return -(-max(lens) // 64) * 64, rows, 1 << (pending - 1).bit_length()

    monkeypatch.setattr(tro, "prefill_pad_dims", pad)
    monkeypatch.setattr(jro, "prefill_pad_dims", pad)
    mine, theirs = irlint.check_bucket_stability(), jir.check_bucket_stability()
    assert mine and _keys(mine) == _keys(theirs)
    assert all(f.rule == "IR401" and f.severity == "error" for f in mine)


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_serve_dtype_check_gives_the_references_findings(kind):
    leaves = [("arg0['embed']['tok']", "bfloat16"),
              ("arg0['layers'][0]['attn']['wq']", "float32"),
              ("arg2[0]['k']", "float16")] + [
        (f"arg0['layers'][{i}]['mlp']['w1']", "float32") for i in range(4)]
    mine = irlint.check_signature(_mt(irlint, kind=kind, float_leaves=leaves))
    theirs = jir.check_signature(_mt(jir, kind=kind, float_leaves=leaves))
    assert _keys(mine) == _keys(theirs)
    assert len(mine) == (4 if kind != "train" else 0)


# -- IR402, IR403 -------------------------------------------------------------


def test_donation_check_flags_large_unkept_leaf_only():
    leaves = [("arg2['k']", 3, 1 << 20, "bfloat16", True),
              ("arg2['v']", 4, 1 << 20, "bfloat16", False),
              ("arg3['len']", 5, 8, "int32", False)]
    mine = irlint.check_donation(_mt(
        irlint, donated=[DonatedLeaf(*x) for x in leaves]))
    theirs = jir.check_donation(_mt(
        jir, donated=[jir.DonatedLeaf(*x) for x in leaves]))
    (f,) = mine
    assert f.rule == "IR402" and "arg2['v']" in f.message
    assert _keys(mine) == _keys(theirs)


def test_host_sync_check_gives_the_references_findings():
    ops = ["aten._local_scalar_dense", "aten._local_scalar_dense",
           "aten.nonzero"]
    mine = irlint.check_callbacks(_mt(irlint, callbacks=ops))
    theirs = jir.check_callbacks(_mt(jir, callbacks=ops))
    assert _keys(mine) == _keys(theirs)
    assert "2 `aten._local_scalar_dense`" in mine[0].message


def test_host_sync_recorder_sees_value_reads_and_host_copies():
    from repro_torch.launch.dryrun import fake_mode
    rec = irlint.HostSyncRecorder()
    with fake_mode():                   # the dry run's tensors: no values
        x = torch.ones(4, device="meta")
    with rec:
        y = x * 2
        v = y.sum().item()           # a fake tensor has no value: 0
        y.cpu()
        torch.nonzero(y)
        (x + 1).exp()
    assert v == 0
    assert rec.syncs == ["aten._local_scalar_dense",
                         "aten._to_copy(to the host)", "aten.nonzero"]
    rec = irlint.HostSyncRecorder()
    with rec:
        torch.ones(3).sum().item()   # on the host: a read, no copy
    assert rec.syncs == ["aten._local_scalar_dense"]


# -- IR404 --------------------------------------------------------------------


CONTRACT_CASES = [
    ({}, {"all-gather": 1.0e6}),                                 # missing
    ({"all-gather": 1.0e6}, {"all-gather": 2.0e6}),              # regressed
    ({"all-gather": 1.0e6}, {"all-gather": 0.5e6}),              # improved
    ({"all-gather": 1.0e6}, {"all-gather": 1.01e6}),             # in tol
    ({"all-reduce": 500.0}, {"all-reduce": 1400.0}),             # abs tol
    ({"all-to-all": 4.0e9, "total": 4.0e9},
     {"all-to-all": 4.2e9, "reduce-scatter": 3.0e3, "total": 4.2e9}),
]


@pytest.mark.parametrize("want,got", CONTRACT_CASES)
def test_contract_check_gives_the_references_findings(want, got):
    key = "tiny|decode_tiny|4x2"
    cdata = {key: {"collective_bytes": want}} if want else {}
    mine = irlint.check_contract(_mt(irlint, collectives=got), cdata)
    theirs = jir.check_contract(_mt(jir, collectives=got), cdata)
    assert _keys(mine) == _keys(theirs)
    def moves(fs):           # (kind, direction, contract, measured)
        return [re.search(r"(\S+) bytes/device (regressed|improved) "
                          r"([0-9.e+]+) -> ([0-9.e+]+)", f.message).groups()
                for f in fs if "bytes/device" in f.message]
    assert moves(mine) == moves(theirs)


def test_stale_contract_entries_as_the_reference():
    cdata = {"tiny|decode_tiny|4x2": {}, "gone|x|1x1": {}}
    mine = irlint.check_stale_contracts([_mt(irlint)], cdata)
    theirs = jir.check_stale_contracts([_mt(jir)], cdata)
    assert _keys(mine) == _keys(theirs)
    assert [f.severity for f in mine] == ["warning"]


# -- PAL205 -------------------------------------------------------------------


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15flash_fwd_tc_v1PKfS0_Pfi' for 'sm_90a'
ptxas info    : Function properties for _Z15flash_fwd_tc_v1PKfS0_Pfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 40960 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11scan_kernelILi16EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z11scan_kernelILi16EEvPf
    16 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_ptxas_log_parsed():
    ks = irlint.parse_ptxas(PTXAS)
    assert [(k["name"][:15], k["registers"], k["smem"], k["spill_stores"],
             k["spill_loads"]) for k in ks] == [
        ("flash_fwd_tc_v1", 168, 40960, 0, 0),
        ("scan_kernelILi1", 255, 0, 24, 20)]


def test_kernel_budget_spill_is_a_warning_smem_an_error():
    found = irlint.check_kernel_budget("lib", PTXAS, irlint.H100_LIMITS)
    assert [(f.severity, f.src_line.split(":")[-1]) for f in found] == [
        ("warning", "spill")]
    tight = dict(irlint.H100_LIMITS, static_smem_bytes=32768)
    found = irlint.check_kernel_budget("lib", PTXAS, tight)
    assert [(f.severity, f.src_line.split(":")[-1]) for f in found] == [
        ("error", "budget"), ("warning", "spill")]
    assert "40960 bytes of static shared memory" in found[0].message


def test_injected_pal205_over_smem_budget_exits_1(monkeypatch, capsys):
    from repro_torch.hopper import build
    over = PTXAS.replace("40960 bytes smem", "65536 bytes smem")
    monkeypatch.setattr(build, "library_log", lambda name: over)
    assert irlint.main(["--select", "PAL205"]) == 1
    out = capsys.readouterr().out
    assert "PAL205" in out and "65536 bytes of static shared memory" in out
    monkeypatch.setattr(build, "library_log", lambda name: PTXAS)
    assert irlint.main(["--select", "PAL205"]) == 0       # spills: warnings
    assert irlint.main(["--select", "PAL205", "--strict"]) == 1


def test_unbuilt_libraries_are_warnings_here():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the libraries may be built")
    found, rows = irlint.kernel_budgets()
    from repro_torch.hopper import build
    assert set(rows) == set(build.KERNELS)
    assert {f.severity for f in found} <= {"warning"}


# -- injected faults through the CLI, on synthetic targets ---------------------


def test_injected_ir402_unkept_donation_exits_1(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.chdir(tmp_path)
    bad = _mt(irlint, donated=[DonatedLeaf("arg2['k']", 3, 1 << 20,
                                           "bfloat16", aliased=False)])
    monkeypatch.setattr(irlint, "measure_all", lambda archs=None: [bad])
    assert irlint.main(["--select", "IR402"]) == 1
    assert "IR402" in capsys.readouterr().out
    good = _mt(irlint, donated=[DonatedLeaf("arg2['k']", 3, 1 << 20,
                                            "bfloat16", aliased=True)])
    monkeypatch.setattr(irlint, "measure_all", lambda archs=None: [good])
    assert irlint.main(["--select", "IR402"]) == 0


def test_injected_ir403_host_sync_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bad = _mt(irlint, callbacks=["aten._local_scalar_dense"])
    monkeypatch.setattr(irlint, "measure_all", lambda archs=None: [bad])
    assert irlint.main(["--select", "IR403"]) == 1
    assert "_local_scalar_dense" in capsys.readouterr().out


def test_injected_ir404_contract_regression_exits_1(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    mt = _mt(irlint, collectives={"all-gather": 2.0e6})
    monkeypatch.setattr(irlint, "measure_all", lambda archs=None: [mt])
    cpath = tmp_path / "contracts.json"
    cpath.write_text(json.dumps({"entries": {
        mt.key: {"collective_bytes": {"all-gather": 1.0e6}}}}))
    assert irlint.main(["--select", "IR404", "--contracts", str(cpath)]) == 1
    assert "regressed" in capsys.readouterr().out
    # an improvement is a warning: clean by default, failing under --strict
    cpath.write_text(json.dumps({"entries": {
        mt.key: {"collective_bytes": {"all-gather": 4.0e6}}}}))
    assert irlint.main(["--select", "IR404", "--contracts", str(cpath)]) == 0
    assert irlint.main(["--select", "IR404", "--strict", "--contracts",
                        str(cpath)]) == 1


def test_write_contracts_keeps_other_archs(tmp_path, monkeypatch):
    cpath = str(tmp_path / "c.json")
    a = _mt(irlint, collectives={"all-reduce": 7.0, "total": 7.0})
    b = _mt(irlint, key="llama3.2-1b|decode_32k|16x16", arch="llama3.2-1b")
    assert contracts.write_contracts([a, b], cpath) == 2
    a2 = _mt(irlint, collectives={"all-reduce": 9.0, "total": 9.0})
    assert contracts.write_contracts([a2], cpath, keep_others=True) == 2
    got = contracts.load_contracts(cpath)
    assert got[a.key]["collective_bytes"]["all-reduce"] == 9.0
    assert b.key in got
    monkeypatch.setattr(irlint, "measure_all", lambda archs=None: [a2])
    assert irlint.main(["--write-contracts", "--contracts", cpath]) == 0
    assert list(contracts.load_contracts(cpath)) == [a2.key]


def test_cli_module_entry_point():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.irlint",
                        "--select", "PAL205"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == (0 if not torch.cuda.is_available()
                            else r.returncode), r.stdout + r.stderr
    assert "targets and libraries checked" in r.stdout


# -- the tiny targets traced for real, in a subprocess -------------------------


TINY = textwrap.dedent("""
    import json, sys
    from repro_torch.analysis import contracts, irlint
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.optim import adam

    out = {}
    measured = irlint.measure_all(archs=["tiny"])
    out["targets"] = {mt.key: dict(
        kind=mt.kind, donated=len(mt.donated),
        kept=sum(d.aliased for d in mt.donated), syncs=mt.callbacks,
        floats=sorted({d for _, d in mt.float_leaves}),
        kept_f32=len(mt.kept_f32), collectives=mt.collectives,
        path=mt.path) for mt in measured}
    irlint.measure_all = lambda archs=None: measured
    out["rc_committed"] = irlint.main(["--arch", "tiny"])
    out["rc_write"] = irlint.main(["--arch", "tiny", "--write-contracts",
                                   "--contracts", "contracts.json"])
    out["rc_written"] = irlint.main(["--arch", "tiny", "--contracts",
                                     "contracts.json"])
    out["written"] = contracts.load_contracts("contracts.json")
    data = json.load(open("contracts.json"))
    for e in data["entries"].values():
        e["collective_bytes"]["all-reduce"] = 1.0
    json.dump(data, open("contracts.json", "w"))
    out["rc_doctored"] = irlint.main(["--arch", "tiny", "--select", "IR404",
                                      "--contracts", "contracts.json"])

    # the faults, each on its target (the train step at one microbatch:
    # the donation does not depend on their number)
    targets = {t.shape_name: t for t in contracts.default_targets(["tiny"])}
    dryrun.TRAIN_MICROBATCHES["tiny"] = 1
    update = adam.update

    def allocating(grads, state, params, **kw):
        p, s, m = update(grads, state, params, **kw)
        return tree_map(lambda t: t.detach().clone(), p), s, m

    adam.update = allocating
    bad = contracts.measure_target(targets["train_tiny"])
    adam.update = update
    irlint.measure_all = lambda archs=None: [bad]
    out["rc_allocating"] = irlint.main(["--select", "IR402"])
    out["allocating_unkept"] = sum(not d.aliased for d in bad.donated)

    scan = M.decode_scan

    def syncing(params, cfg, cache, last_token, cache_len, *a, **kw):
        cache_len.max().item()
        return scan(params, cfg, cache, last_token, cache_len, *a, **kw)

    M.decode_scan = syncing
    bad = contracts.measure_target(targets["decode_tiny"])
    M.decode_scan = scan
    irlint.measure_all = lambda archs=None: [bad]
    out["rc_item"] = irlint.main(["--select", "IR403"])
    out["item_syncs"] = bad.callbacks
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", TINY], env=env,
                       cwd=str(tmp_path_factory.mktemp("irlint")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), r.stdout


def test_tiny_targets_clean_against_the_committed_contracts(tiny):
    res, stdout = tiny
    assert res["rc_committed"] == 0, stdout[-3000:]
    t = res["targets"]
    assert sorted(t) == sorted(k.key for k in contracts.default_targets(
        ["tiny"]))
    for key, m in t.items():
        assert m["syncs"] == [], key                       # IR403
        assert m["kept"] == m["donated"], key              # IR402
    assert t["tiny|train_tiny|4x2"]["donated"] > 0
    assert t["tiny|decode_tiny|4x2"]["path"].endswith("models/model.py")
    for key in ("tiny|prefill_tiny|4x2", "tiny|decode_tiny|4x2"):
        assert t[key]["floats"] == ["bfloat16"], key       # IR401(b)
        assert t[key]["kept_f32"] > 0, key                 # the norms


def test_tiny_targets_round_trip_through_write_contracts(tiny):
    res, stdout = tiny
    assert res["rc_write"] == 0 and res["rc_written"] == 0, stdout[-3000:]
    committed = contracts.load_contracts(contracts.CONTRACTS_DEFAULT)
    for key, entry in res["written"].items():
        assert entry == committed[key], key


def test_tiny_doctored_contract_exits_1(tiny):
    assert tiny[0]["rc_doctored"] == 1


def test_allocating_optimizer_step_exits_1(tiny):
    res, _ = tiny
    assert res["rc_allocating"] == 1
    assert res["allocating_unkept"] > 0


def test_item_in_decode_scan_exits_1(tiny):
    res, _ = tiny
    assert res["rc_item"] == 1
    assert "aten._local_scalar_dense" in res["item_syncs"]


def test_chip_bounds_imports_no_jax():
    """chip_bounds.py, the memcheck run of every kernel family on the card,
    imports neither jax nor the JAX package (as chip_smoke.py,
    ``tests/test_torch_hygiene.py``), and runs the families of the
    reference's PAL205 harnesses."""
    import ast
    path = os.path.join(ROOT, "chip_bounds.py")
    tree = ast.parse(open(path).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert mods and not [m for m in mods
                         if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    sys.path.insert(0, ROOT)
    try:
        import chip_bounds
    finally:
        sys.path.remove(ROOT)
    # the reference's rwkv6_scan family is the port's wkv6
    assert set(chip_bounds.FAMILIES) == \
        (set(jir.HARNESSES) - {"rwkv6_scan"}) | {"wkv6"}
