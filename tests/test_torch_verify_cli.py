"""The port's verify lint and ``python -m repro_torch.verify`` against the
JAX package's.

The lint cases of ``tests/test_verify_lint.py`` are written twice, in
the reference's idiom (``jnp.asarray``, ``_step``, a replaced ``"kv"``
leaf) and in the port's (``torch.from_numpy``, ``self._tensor``,
``api.decode_step``, an in-place slice write into a pool tensor); each
pair must draw the same rules from the two linters.
Then the port's own runtime tree lints clean with its audited waivers,
and a planted alias is caught.  The CLI's five cases of
``tests/test_verify_cli.py`` run through both packages' ``main`` with the
same arguments: the same exit codes and the same JSON, state counts
included.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.verify.cli import main as jax_main  # noqa: E402
from repro.verify.lint import lint_source as jax_lint_source  # noqa: E402
from repro_torch.verify.cli import main  # noqa: E402
from repro_torch.verify.lint import lint_paths, lint_source  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RUNTIME = ROOT / "src" / "repro_torch" / "runtime"

# name -> (reference snippet, port snippet, module path, rules, ok)
LINT_CASES = {
    "attribute_flagged": ("""
        def f(self):
            return jnp.asarray(self.slot_pos)
    """, """
        def f(self):
            return torch.from_numpy(self.slot_pos)
    """, "mod.py", ["alias-dispatch"], False),
    "unproven_name_flagged": ("""
        def f(self, req):
            frames = getattr(req, "_frames", None)
            return jnp.asarray(frames)
    """, """
        def f(self, req):
            frames = getattr(req, "_frames", None)
            return torch.as_tensor(frames)
    """, "mod.py", ["alias-dispatch"], False),
    "fresh_np_buffer_ok": ("""
        def f(self):
            tokens = np.zeros((4, 1), np.int32)
            tokens[0, 0] = 7
            return jnp.asarray(tokens)
    """, """
        def f(self):
            tokens = np.zeros((4, 1), np.int32)
            tokens[0, 0] = 7
            return self._tensor(tokens)
    """, "mod.py", [], True),
    "direct_np_call_and_snapshot_ok": ("""
        def f(self, a):
            x = jnp.asarray(np.array(a))
            y = jnp.asarray(_snapshot(self.slot_pos))
            return x, y
    """, """
        def f(self, a):
            x = torch.from_numpy(np.array(a)).to(self.device)
            y = self._tensor(_snapshot(self.slot_pos))
            return x, y
    """, "mod.py", [], True),
    "tainted_reassignment_flags": ("""
        def f(self, view):
            buf = np.zeros(4)
            buf = view
            return jnp.asarray(buf)
    """, """
        def f(self, view):
            buf = np.zeros(4)
            buf = view
            return torch.from_numpy(buf)
    """, "mod.py", ["alias-dispatch"], False),
    "raw_host_buffer_into_dispatch_flagged": ("""
        def f(self):
            out, _ = self._step(self.params, self.state,
                                self.alloc.page_table)
            return out
    """, """
        def f(self, tok, pos):
            out, _ = self.api.decode_step(self.params, self.state, tok,
                                          pos, self.alloc.page_table)
            return out
    """, "mod.py", ["alias-dispatch"], False),
    "pool_kv_write_flagged": ("""
        def f(entry, new):
            entry["kv"] = new
    """, """
        def f(entry, src, dst):
            for buf in entry["kv"].values():
                buf[:, dst] = buf[:, src]
    """, "mod.py", ["pool-write"], False),
    "other_key_writes_ok": ("""
        def f(entry, new):
            entry["meta"] = new
    """, """
        def f(entry, src, dst, new):
            entry["meta"] = new
            for buf in entry["meta"].values():
                buf[:, dst] = buf[:, src]
    """, "mod.py", [], True),
    "dict_iteration_in_scheduler_flagged": ("""
        def pick(self, server):
            for req in self.pending.values():
                if req.ready:
                    return req
    """, """
        def pick(self, server):
            for req in self.pending.values():
                if req.ready:
                    return req
    """, "my_scheduler.py", ["ordered-policy"], False),
    "dict_iteration_outside_scheduler_ok": ("""
        def pick(self, server):
            for req in self.pending.values():
                if req.ready:
                    return req
    """, """
        def pick(self, server):
            for req in self.pending.values():
                if req.ready:
                    return req
    """, "workload.py", [], True),
    "minmax_key_over_dict_values_flagged": ("""
        def victim(self, server):
            return max(self.slots.values(), key=lambda s: s.age)
    """, """
        def victim(self, server):
            return max(self.slots.values(), key=lambda s: s.age)
    """, "scheduler.py", ["ordered-policy"], False),
    "sorted_wrap_ok": ("""
        def pick(self, server):
            for k, req in sorted(self.pending.items()):
                return k
    """, """
        def pick(self, server):
            for k, req in sorted(self.pending.items()):
                return k
    """, "scheduler.py", [], True),
    "waiver_with_reason_waives": ("""
        def f(self):
            # verify: waive(alias-dispatch) -- audited: x is immutable
            return jnp.asarray(self.slot_pos)
    """, """
        def f(self):
            # verify: waive(alias-dispatch) -- audited: x is immutable
            return torch.from_numpy(self.slot_pos)
    """, "mod.py", [], True),
    "waiver_block_above_finding_waives": ("""
        def f(self):
            # verify: waive(alias-dispatch) -- audited: frozen at
            # submit time, never written afterwards
            return jnp.asarray(self.slot_pos)
    """, """
        def f(self):
            # verify: waive(alias-dispatch) -- audited: frozen at
            # submit time, never written afterwards
            return torch.from_numpy(self.slot_pos)
    """, "mod.py", [], True),
    "reasonless_waiver_rejected": ("""
        def f(self):
            # verify: waive(alias-dispatch)
            return jnp.asarray(self.slot_pos)
    """, """
        def f(self):
            # verify: waive(alias-dispatch)
            return torch.from_numpy(self.slot_pos)
    """, "mod.py", ["alias-dispatch"], False),
    "waiver_for_wrong_rule_does_not_waive": ("""
        def f(self):
            # verify: waive(pool-write) -- wrong rule entirely
            return jnp.asarray(self.slot_pos)
    """, """
        def f(self):
            # verify: waive(pool-write) -- wrong rule entirely
            return torch.from_numpy(self.slot_pos)
    """, "mod.py", ["alias-dispatch"], False),
}

# waived findings (and bad waivers) each case's pair must agree on
_WAIVED = {"waiver_with_reason_waives": (1, 0),
           "waiver_block_above_finding_waives": (1, 0),
           "reasonless_waiver_rejected": (0, 1)}


def _lint(fn, src, path):
    return fn(textwrap.dedent(src), path)


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_case_draws_the_reference_verdict(case):
    ref_src, port_src, path, rules, ok = LINT_CASES[case]
    want = _lint(jax_lint_source, ref_src, path)
    got = _lint(lint_source, port_src, path)
    assert [f.rule for f in want.findings] == rules
    assert [f.rule for f in got.findings] == rules
    assert got.ok == want.ok == ok
    waived = _WAIVED.get(case, (0, 0))
    assert (len(got.waived), len(got.bad_waivers)) == \
        (len(want.waived), len(want.bad_waivers)) == waived


@pytest.mark.parametrize("src", [
    # a slice of a pool tensor reached through the leaf
    """
    def f(entry, x, dst):
        entry["kv"]["k"][:, dst] = x
    """,
    # a name bound from the leaf, written with an in-place method
    """
    def f(entry, src):
        k = entry["kv"]["k"]
        k.copy_(src)
    """,
    # an augmented write through a loop over (name, tensor) pairs
    """
    def f(blocks, x):
        for entry in blocks.values():
            for name, buf in entry["kv"].items():
                buf[0] += x
    """])
def test_pool_write_forms_of_the_port_flagged(src):
    rep = _lint(lint_source, src, "mod.py")
    assert [f.rule for f in rep.findings] == ["pool-write"]


def test_keyword_host_buffer_into_dispatch_flagged():
    rep = _lint(lint_source, """
        def f(self, tok, pos):
            return self.api.prefill_step(self.params, self.state, tok, pos,
                                         lengths=self.slot_pos)
    """, "mod.py")
    assert [f.rule for f in rep.findings] == ["alias-dispatch"]


def test_planted_from_numpy_into_decode_step_flagged():
    """The live slot positions handed to ``api.decode_step`` through
    ``torch.from_numpy`` instead of ``_snapshot``: one new finding, at
    the decode dispatch."""

    src = (RUNTIME / "serve.py").read_text()
    live = "_snapshot(self.slot_pos, self.device), *extra,"
    assert src.count(live) == 1
    planted = src.replace(live, "torch.from_numpy(self.slot_pos).to("
                          "self.device), *extra,")
    before = lint_source(src, "serve.py")
    after = lint_source(planted, "serve.py")
    assert before.ok and not after.ok
    (finding,) = after.findings
    assert finding.rule == "alias-dispatch"
    assert "slot_pos" in finding.message
    lines = planted.splitlines()
    assert "torch.from_numpy(self.slot_pos)" in lines[finding.line - 1]
    assert "self.api.decode_step(" in lines[finding.line - 3]


def test_runtime_tree_lints_clean():
    rep = lint_paths([RUNTIME])
    assert rep.ok, "\n".join(str(f) for f in
                             rep.findings + rep.bad_waivers)
    # the two audited waivers in serve.py stay visible, not silent: the
    # _tensor helper's from_numpy and the COW page copy
    assert sorted(f.rule for f in rep.waived) == ["alias-dispatch",
                                                  "pool-write"]
    assert all(Path(f.path).name == "serve.py" for f in rep.waived)


def test_lint_of_a_missing_path_is_an_error(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        lint_paths([tmp_path / "nope"])
    assert main(["lint", str(tmp_path / "nope")]) == 2
    assert "no such file" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the CLI, case for case against the reference's
# ---------------------------------------------------------------------------


def _json_of(fn, argv, capsys):
    rc = fn(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_lint_json_exits_zero_on_clean_tree(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc, out = _json_of(main, ["lint", "--json"], capsys)
    ref_rc, ref = _json_of(jax_main, ["lint", "--json"], capsys)
    assert rc == ref_rc == 0
    assert out["ok"] is ref["ok"] is True
    assert out["findings"] == ref["findings"] == []
    assert len(out["waived"]) >= 2 and len(ref["waived"]) >= 2
    assert all(w["path"].startswith("src/repro_torch/runtime/")
               for w in out["waived"])


_CHECK_KEYS = ("name", "kind", "status", "states", "transitions",
               "max_depth", "frontier_peak", "bound_reason", "violations")


def test_check_bounded_run_reports_and_passes(tmp_path, capsys):
    argv = ["check", "--json", "--max-states", "300"]
    rc, out = _json_of(main, argv + ["--trail-dir", str(tmp_path / "p")],
                       capsys)
    ref_rc, ref = _json_of(jax_main,
                           argv + ["--trail-dir", str(tmp_path / "r")],
                           capsys)
    assert rc == ref_rc == 0
    assert (out["ok"], out["exhaustive"]) == (ref["ok"], ref["exhaustive"]) \
        == (True, False)
    assert [{k: c[k] for k in _CHECK_KEYS} for c in out["checks"]] == \
        [{k: c[k] for k in _CHECK_KEYS} for c in ref["checks"]]
    by_name = {c["name"]: c for c in out["checks"]}
    assert by_name["alloc-invariants"]["status"] == "bounded"
    assert by_name["alloc-invariants"]["bound_reason"] == "max_states"
    assert by_name["alloc-invariants"]["frontier_peak"] > 0
    assert by_name["server-fcfs-pressure"]["status"] == "verified"
    assert by_name["spec-cycle"]["status"] == "verified"


def test_mutants_write_trails_that_replay_reproduces(tmp_path, capsys):
    rc, out = _json_of(main, ["mutants", "--json", "--trail-dir",
                              str(tmp_path / "p")], capsys)
    ref_rc, ref = _json_of(jax_main, ["mutants", "--json", "--trail-dir",
                                      str(tmp_path / "r")], capsys)
    assert rc == ref_rc == 0 and out["ok"] is ref["ok"] is True
    keys = ("mutant", "caught", "reproduced", "ops", "states", "message")
    assert [{k: r[k] for k in keys} for r in out["mutants"]] == \
        [{k: r[k] for k in keys} for r in ref["mutants"]]
    assert len(out["mutants"]) == 6
    for r in out["mutants"]:
        assert r["caught"] and r["reproduced"], r
        payload = json.loads(open(r["trail"]).read())
        assert payload["allocator"] == r["mutant"]
        assert payload["ops"]
    trail = out["mutants"][0]["trail"]
    assert main(["replay", "--trail", trail]) == 1
    assert "REPRODUCED" in capsys.readouterr().out
    # the trail format is shared: the reference replays the port's trail
    assert jax_main(["replay", "--trail", trail]) == 1
    assert "REPRODUCED" in capsys.readouterr().out


def test_replay_clean_trail_exits_zero(tmp_path, capsys):
    trail = tmp_path / "clean.json"
    trail.write_text(json.dumps({
        "model": "allocator", "allocator": "real",
        "config": {"n_slots": 2, "page_size": 2, "pages_per_slot": 2,
                   "n_pages": 3},
        "ops": [["ensure", 0, 4], ["share", 0, 1, 2], ["release", 0]],
    }))
    assert main(["replay", "--trail", str(trail)]) == 0
    out = capsys.readouterr().out
    assert jax_main(["replay", "--trail", str(trail)]) == 0
    assert "clean" in out and out == capsys.readouterr().out


def test_unknown_trail_model_is_an_error(tmp_path):
    trail = tmp_path / "bogus.json"
    trail.write_text(json.dumps({"model": "nope", "ops": []}))
    assert main(["replay", "--trail", str(trail)]) == 2
    assert jax_main(["replay", "--trail", str(trail)]) == 2


def test_python_m_repro_torch_verify_lint():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", "lint"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("0 finding(s), 0 bad waiver(s), "
                                        "2 waived")
