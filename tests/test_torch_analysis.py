"""The port's source lints and the kernel pass's CPU half
(``repro_torch.analysis``).

* the JAX package's rule tests, ported: the framework-neutral passes (lock,
  wallclock, bare set iteration) run over the same fixture trees as the
  JAX passes and must report the same (rule, line) findings;
* ``det:unkeyed-prng`` aimed at torch: a draw without ``generator=``;
* the pragma, fingerprint and baseline machinery;
* the kernel pass on the CPU: clean on the real tree, and it catches an
  over-budget shared-memory launch, a head_dim no kernel takes, a table walk
  missing its clip and a leaking mask;
* the annotations the lints hold the port's concurrency surface to, and
  the repairs they drove (the launch counters' keys read under the lock);
* the real tree is clean for the lock, determinism and kernel passes, and
  every baseline entry has a reason.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch

from repro.analysis import determinism as jax_determinism
from repro.analysis import locklint as jax_locklint

from repro_torch.analysis import (
    default_baseline, default_root, load_baseline, run_passes, split_baselined)
from repro_torch.analysis import determinism, kernel_check, locklint
from repro_torch.analysis.common import Finding, parse_pragmas
from repro_torch.kernels import costs

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"
JAX_SRC = ROOT / "src" / "repro"


def _tree(tmp_path: Path, files: dict) -> Path:
    root = tmp_path / "fixture"
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def _rule_lines(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


# ------------------------------------------- the lock and determinism rules --

LOCK_FIXTURES = {
    "unguarded-and-wrong-thread": ({"mod.py": """\
        import threading

        class Chan:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0  # guarded-by: self._lock
                self.items = []  # owned-by: worker

            def bad_unguarded(self):
                self.count += 1

            def good_guarded(self):
                with self._lock:
                    self.count += 1

            def good_thread(self):  # thread: worker
                self.items.append(1)

            def good_nested(self):  # thread: worker
                def inner():
                    self.items.append(2)
                return inner

            def bad_thread(self):
                self.items.append(3)
    """}, ["lock:thread", "lock:unguarded"]),
    "init-exempt": ({"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: self._lock
                self.n = 1  # __init__ writes are exempt: not shared yet
    """}, []),
    "pragma-line-and-def": ({"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: self._lock

            def waived_line(self):
                return self.n  # analysis: allow(lock:unguarded) — torn read tolerated

            def waived_def(self):  # analysis: allow(lock:unguarded) — whole body audited
                self.n += 1
                return self.n

            def still_bad(self):
                return self.n
    """}, ["lock:unguarded"]),
    "cross-object-bind": ({
        "pool.py": """\
            class Pool:
                def __init__(self):
                    self.state = None  # owned-by: pool-thread
        """,
        "user.py": """\
            # analysis: bind(pool=Pool)

            def misuse(pool):
                pool.state = 3

            def fine(pool):  # thread: pool-thread
                pool.state = 4
        """}, ["lock:thread"]),
    "shared-global-rebind": ({
        "sing.py": """\
            class T:
                pass

            # analysis: shared-global(TRACER)
            TRACER = T()
        """,
        "evil.py": """\
            from fixture import sing

            def swap():
                sing.TRACER = None
        """}, ["lock:global-rebind"]),
    "pragma-without-reason": ({"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: self._lock

            def f(self):
                return self.n  # analysis: allow(lock:unguarded)
    """}, ["analysis:pragma-no-reason", "lock:unguarded"]),
}


@pytest.mark.parametrize("name", sorted(LOCK_FIXTURES))
def test_lock_rules_match_the_jax_pass(tmp_path, name):
    files, rules = LOCK_FIXTURES[name]
    root = _tree(tmp_path, files)
    found = locklint.run(root)
    assert sorted(f.rule for f in found) == rules
    assert _rule_lines(found) == _rule_lines(jax_locklint.run(root))


DET_FIXTURES = {
    "wallclock": ({"sched.py": """\
        import time

        def decide(queue):
            return time.time() < queue[0].deadline

        def metered(stats):
            stats.t = time.perf_counter()  # analysis: allow(det:wallclock) — stats only
    """}, ["det:wallclock"], "decide"),
    "bare-set-iter": ({"sched.py": """\
        def order(slots):
            live = {s for s in slots if s.busy}
            out = []
            for s in live:
                out.append(s)
            return out

        def fine(slots):
            live = {s for s in slots if s.busy}
            return [s for s in sorted(live)]
    """}, ["det:bare-set-iter"], "order"),
    "entropy": ({"sched.py": """\
        import os
        import numpy as np

        def seeds():
            return os.urandom(8), np.random.randint(0, 9)

        def fine(rng):
            return rng.integers(0, 9)
    """}, ["det:wallclock", "det:wallclock"], "seeds"),
}


@pytest.mark.parametrize("name", sorted(DET_FIXTURES))
def test_determinism_rules_match_the_jax_pass(tmp_path, name):
    files, rules, where = DET_FIXTURES[name]
    root = _tree(tmp_path, files)
    found = determinism.run(root)
    assert sorted(f.rule for f in found) == rules
    assert all(where in f.message for f in found)
    assert _rule_lines(found) == _rule_lines(jax_determinism.run(root))


def test_det_unkeyed_prng_flags_torch_draws_without_a_generator(tmp_path):
    root = _tree(tmp_path, {"samp.py": """\
        import torch

        def bad_sample(logits):
            return torch.multinomial(torch.softmax(logits, -1), 1)

        def bad_noise(x):
            return x + torch.randn(x.shape)

        def bad_like(x):
            return torch.rand_like(x)

        def bad_inplace(x):
            return x.uniform_()

        def bad_method(p):
            return p.bernoulli()

        def bad_none(x, g=None):
            return torch.randint(0, 9, (3,), generator=None)

        def good(x, gen):
            return torch.randn(x.shape, generator=gen) + x.normal_(generator=gen)

        def good_seeded_numpy(rng):
            return rng.normal(0.0, 1.0)
    """})
    found = determinism.run(root)
    assert [f.rule for f in found] == ["det:unkeyed-prng"] * 6
    assert [f.scope for f in found] == ["bad_sample", "bad_noise", "bad_like", "bad_inplace",
                                        "bad_method", "bad_none"]


def test_det_unkeyed_prng_passes_the_samplers_threefry_bits():
    # the sampler draws no torch random value: its bits are threefry of
    # fold_in(PRNGKey(seed), token index), which the rule protects
    found = determinism.run(PORT_SRC, subset=("core/sampling.py", "serving/spec_decode.py"))
    assert found == []


def test_comment_block_pragma_covers_following_def():
    waivers_line, waivers_def, findings = parse_pragmas(textwrap.dedent("""\
        # analysis: allow(lock:unguarded) — two-line justification that
        # wraps onto a continuation comment line
        def target(self):
            return self.n
    """), "mod.py")
    assert findings == []
    assert waivers_def == {3: {"lock:unguarded"}}


# ---------------------------------------------------------------- baseline --

def test_baseline_format_and_suppression(tmp_path):
    f = Finding("lock", "lock:unguarded", "mod.py", 10, "msg")
    bl = tmp_path / "baseline.txt"
    bl.write_text("# comment\n"
                  f"{f.fingerprint} lock:unguarded mod.py — tracked debt, see the roadmap\n")
    fps, errors = load_baseline(bl)
    assert errors == [] and fps == {f.fingerprint}
    active, suppressed = split_baselined([f], fps)
    assert active == [] and suppressed == [f]


def test_baseline_rejects_missing_reason_and_bad_fingerprint(tmp_path):
    bl = tmp_path / "baseline.txt"
    bl.write_text("deadbeefcafe lock:unguarded mod.py\n"
                  "nothex lock:unguarded mod.py — why\n")
    fps, errors = load_baseline(bl)
    assert fps == set()
    assert len(errors) == 2
    assert "no reason" in errors[0]
    assert "malformed" in errors[1]


def test_fingerprints_ignore_the_line_and_fold_in_the_scope():
    a = Finding("lock", "lock:unguarded", "mod.py", 10, "msg", scope="A.f")
    assert a.fingerprint == Finding("lock", "lock:unguarded", "mod.py", 99, "msg",
                                    scope="A.f").fingerprint
    b = Finding("lock", "lock:unguarded", "mod.py", 10, "msg", scope="B.g")
    assert a.fingerprint != b.fingerprint
    assert a.scope in a.render()
    # a baseline entry waives its own scope only
    active, suppressed = split_baselined([a, b], {a.fingerprint})
    assert active == [b] and suppressed == [a]


def test_every_baseline_entry_has_a_reason():
    fps, errors = load_baseline(default_baseline())
    assert errors == []
    assert default_baseline().parent == PORT_SRC / "analysis"


def test_cli_rejects_unknown_pass_listing_valid_names(capsys):
    from repro_torch.analysis.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--pass", "bogus"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    for name in ("lock", "kernel", "determinism", "program"):
        assert name in err


def test_default_root_is_the_port():
    assert default_root() == PORT_SRC


# ------------------------------------------------ the kernel pass, on the CPU --

def test_kernel_pass_is_clean_on_the_cpu():
    stats = {}
    assert kernel_check.run(PORT_SRC, stats=stats) == []
    # 13 act-quant, 18 TLMM, 22 prefill and 80 walk cases, each contract-checked
    assert stats == {"launches": stats["launches"], "contracts": 133, "cases": 0, "max_err": {}}
    assert stats["launches"] > 400


def test_kernel_pass_catches_an_over_budget_smem_launch():
    where = {"paged_decode_attention": ("kernels/paged_attention/ops.py", 1)}
    huge = kernel_check.Launch(
        "paged_decode_attention", "8M positions",
        costs.decode_attention_cost([1 << 23], 8, 5, 128, paged=True, cap=1 << 23))
    found = kernel_check.check_launches([huge], where)
    assert [f.rule for f in found] == ["kernel:smem"]
    fits = kernel_check.Launch("paged_decode_attention", "2048 positions",
                               costs.decode_attention_cost([2048], 8, 5, 128, paged=True,
                                                           cap=2048))
    assert kernel_check.check_launches([fits], where) == []


def test_kernel_pass_catches_a_head_dim_no_kernel_takes():
    from repro_torch.configs import get_config
    import dataclasses

    cfg = dataclasses.replace(get_config("smollm-135m"), head_dim=96)
    _, problems = kernel_check.served_launches(cfg)
    assert problems and "head_dim 96" in problems[0]
    cfg = dataclasses.replace(get_config("bitnet-730m"), d_ff=4098)
    _, problems = kernel_check.served_launches(cfg)
    assert any("w_down: K=4098" in p for p in problems)


def _unclipped_gather(pages, tables):
    b, p = tables.shape
    n, hkv, bs, d = pages.shape
    return pages[tables.long()].transpose(1, 2).reshape(b, hkv, p * bs, d)


def test_kernel_pass_catches_a_table_walk_missing_its_clip():
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference

    def walk(q, k_pages, v_pages, tables, lengths, starts=None, **kw):
        return decode_attention_reference(q, _unclipped_gather(k_pages, tables),
                                          _unclipped_gather(v_pages, tables), lengths, starts)

    found, n = kernel_check.check_contracts({"paged_decode_attention": walk})
    bad = [f for f in found if f.scope == "paged_decode_attention"]
    assert bad and all(f.rule in ("kernel:contract", "kernel:eval-error") for f in bad)
    assert not [f for f in found if f.scope != "paged_decode_attention"]


def test_kernel_pass_catches_a_leaking_mask():
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference

    def leaky(q, k, v, lengths, starts=None, **kw):  # ignores the window's start
        return decode_attention_reference(q, k, v, lengths, None)

    found, _ = kernel_check.check_contracts({"decode_attention": leaky})
    assert {f.rule for f in found} == {"kernel:contract"}
    assert all("starts" in f.message for f in found)


def test_card_cases_cover_the_hopper_kernels_edges():
    cases = kernel_check.device_cases()
    by = {k: [c for c in cases if c.kernel == k] for k in kernel_check.LAUNCHES}
    assert all(by.values())
    ms = {int(c.label.split("M=")[1].split()[0]) for c in by["tlmm"]}
    assert ms == {1, 4, 8, 9, 20, 130}
    assert {c.label.split("(")[-1] for c in by["tlmm"]} == {"split-K)", "MMA)"}
    assert all(int(c.label.split("N=")[1].split()[0]) % 128 for c in by["tlmm"])
    ss = {int(c.label.split("S=")[1].split()[0]) for c in by["prefill_attention"]}
    assert {1, 63, 64, 65, 257} <= ss
    assert {c.repeat for c in by["decode_attention_quant"]} == {1, 5}
    tables = by["paged_decode_attention"][0].operands["tables"].data
    assert (tables == 0).any() and (tables == 7).any() and (tables > 7).any()
    assert any("starts" in c.label for c in by["paged_decode_attention_quant"])


def test_b2_is_held_to_an_f64_evaluation_within_a_small_limit():
    """B2's limit follows from the f32 plain version's own distance from an
    f64 evaluation, and stays small: the plain version passes at every B2
    case, and a 1e-5 fault in the last row (a last-tile mask gone wrong)
    fails at every one."""
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference as ref

    cases = kernel_check.device_cases(["prefill_attention"])
    assert len(cases) == 22
    for case in cases:
        args = kernel_check._resolve(case.plain_args, kernel_check._plain_named(case))
        want = ref(*args)
        exact = ref(*(t.double() for t in args))
        assert exact.dtype == torch.float64
        err, limit = kernel_check.against_f64(want, want, exact)
        assert err <= limit <= 5e-6, case.label
        bad = want.clone()
        bad[0, 0, -1] += 1e-5
        err, limit = kernel_check.against_f64(bad, want, exact)
        assert err > limit, case.label


@pytest.mark.gpu
def test_kernel_pass_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernel pass's card half needs a CUDA device (chip_smoke.py runs it)")
    stats = {}
    assert kernel_check.run(PORT_SRC, device="cuda", stats=stats) == []
    assert stats["cases"] == 133


# ------------------------------------------------ the concurrency surface --

def _annotations(path: Path, root: Path):
    from repro_torch.analysis.common import AnalyzedFile

    return locklint.collect_annotations([AnalyzedFile(path, root)])


@pytest.mark.parametrize("rel,classes", [
    ("serving/async_engine.py", ("AsyncEngine",)),
    ("obs/trace.py", ("Tracer",)),
    ("obs/metrics.py", ("Counter", "Gauge", "_WindowStat")),
])
def test_port_is_annotated_as_the_jax_package(rel, classes):
    port = _annotations(PORT_SRC / rel, PORT_SRC)
    jax_ = _annotations(JAX_SRC / rel, JAX_SRC)
    for cls in classes:
        assert jax_[cls], cls
        assert port[cls] == jax_[cls] | {k: v for k, v in port[cls].items() if k not in jax_[cls]}
    text = (PORT_SRC / rel).read_text()
    assert text.count("# thread:") >= (JAX_SRC / rel).read_text().count("# thread:")


def test_lock_and_determinism_passes_are_clean_on_the_port():
    results = run_passes(["lock", "determinism"], root=PORT_SRC)
    assert results == {"lock": [], "determinism": []}
    # the engine's timing calls each carry their reason
    assert (PORT_SRC / "serving/core.py").read_text().count("allow(det:wallclock) —") == 16
    assert set(locklint.DEFAULT_SUBSET) >= {"kernels/__init__.py", "serving/async_engine.py",
                                            "obs/trace.py", "obs/metrics.py"}


def test_launch_counter_keys_are_read_under_the_lock():
    """The lock pass found ``LaunchCounts.recording`` and ``__len__``
    reading ``_counts`` without its lock; both take it now, and counts stay
    exact while captures record on other threads."""
    from repro_torch.kernels import LaunchCounts

    found = locklint.run(PORT_SRC, subset=("kernels/__init__.py",))
    assert found == []
    counts = LaunchCounts(("a", "b"))
    stop = threading.Event()

    def capture():
        while not stop.is_set():
            with counts.recording() as rec:
                counts.add("a")
            assert rec == {"a": 1, "b": 0} and len(counts) == 2

    def launch():
        for _ in range(2000):
            counts.add("b")

    t = threading.Thread(target=capture)
    t.start()
    workers = [threading.Thread(target=launch) for _ in range(3)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    t.join()
    assert counts["a"] == 0 and counts["b"] == 6000


def test_cli_lint_passes_exit_zero_on_the_port():
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--pass", "lock",
                          "--pass", "determinism"], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK: no non-baselined findings" in res.stdout
