"""The port's checkpoint format and asynchronous snapshots.

Checkpoints cross between the packages both ways, bit for bit (bf16 leaves
as their ``uint16`` bits under the ``__bf16__`` prefix, leaves keyed by
``keystr`` paths); the durability contracts of
``tests/test_checkpoint_data.py`` hold for the port; the snapshotter's
cadence, pruning and ``latest`` are the JAX package's; and a snapshotted
training run resumes bit for bit, in this process and after a SIGKILL of
the writer (the contract of ``tests/test_faults.py``'s durability gates,
without guards).  Everything runs on the CPU, where the snapshot copy is a
plain ``clone``; the card's device copy and side-stream fetch are held by
``tests/test_torch_cuda.py``.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

import repro.checkpoint as jckpt                               # noqa: E402
from repro.configs import get_arch                             # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob  # noqa: E402
from repro_torch.checkpoint import (AsyncSnapshotter,          # noqa: E402
                                    CheckpointError, load_meta, restore,
                                    save, verify)
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.faults import DivergenceBreaker               # noqa: E402
from repro_torch.models import state_from_numpy                # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.runtime import PlanExecutor, compile_plan     # noqa: E402
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa: E402
                              tree_map)

ROOT = Path(__file__).resolve().parents[1]


def _jax_state():
    """A JAX trainer state (bf16 params and gbuf, f32 moments, int32
    counters) of reduced qwen2-0.5b, with non-trivial moments."""
    cfg = get_arch("qwen2-0.5b").reduced().with_(remat="none", n_layers=1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    tr = JTrainer(cfg, mesh, opt=JOptConfig(),
                  async_cfg=JAsyncConfig(delay_rounds=1))
    st = tr.init_state(jax.random.PRNGKey(0))
    st["opt"]["m"] = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32) * 0.5, st["params"])
    st["gbuf"] = jax.tree_util.tree_map(lambda p: p * 2, st["params"])
    st["step"] = jnp.int32(7)
    return st


def _port_like(jstate):
    """The port's trainer state of the same structure, all zeros."""
    tree = jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)),
                                  jstate)
    return state_from_numpy(tree, "cpu")


def _bits(x):
    """A JAX array or torch tensor as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_keystr_paths_match_jax():
    jstate = _jax_state()
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(jstate)]
    got = [p for p, _ in tree_leaves_with_path(_port_like(jstate))]
    assert got == want
    assert tree_leaves_with_path(torch.ones(2))[0][0] == ""


def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path):
    jstate = _jax_state()
    jckpt.save(str(tmp_path / "ck"), jstate, step=7, meta={"arch": "x"})
    like = _port_like(jstate)
    got = restore(str(tmp_path / "ck"), like)
    jleaves = jax.tree_util.tree_leaves(jstate)
    tleaves = tree_leaves(got)
    assert len(jleaves) == len(tleaves)
    for want, have, ref in zip(jleaves, tleaves, tree_leaves(like)):
        assert have.dtype == ref.dtype and have.device == ref.device
        np.testing.assert_array_equal(_bits(have), _bits(want))
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert load_meta(str(tmp_path / "ck"))["arch"] == "x"


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path):
    jstate = _jax_state()
    tstate = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              "cpu")
    save(str(tmp_path / "port"), tstate, step=7)
    jckpt.save(str(tmp_path / "jax"), jstate, step=7)
    got = jckpt.restore(str(tmp_path / "port"),
                        jax.tree_util.tree_map(jnp.zeros_like, jstate))
    for want, have in zip(jax.tree_util.tree_leaves(jstate),
                          jax.tree_util.tree_leaves(got)):
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(_bits(have), _bits(want))
    # the same files: equal key sets and step (the digests differ with
    # the zip timestamps)
    pm, jm = load_meta(str(tmp_path / "port")), load_meta(str(tmp_path / "jax"))
    assert pm["keys"] == jm["keys"] and pm["step"] == jm["step"] == 7
    assert set(np.load(str(tmp_path / "port" / "state.npz")).files) == \
        set(np.load(str(tmp_path / "jax" / "state.npz")).files)
    assert any(k.startswith("__bf16__") for k in pm["keys"])


def test_restore_casts_to_the_like_dtype_as_jax_does(tmp_path):
    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    save(str(tmp_path / "ck"), {"w": torch.from_numpy(x)})
    got = restore(str(tmp_path / "ck"),
                  {"w": torch.zeros((3, 4), dtype=torch.bfloat16)})
    want = jckpt.restore(str(tmp_path / "ck"),
                         {"w": jnp.zeros((3, 4), jnp.bfloat16)})
    np.testing.assert_array_equal(_bits(got["w"]), _bits(want["w"]))


# ---------------------------------------------------------------------------
# the durability contracts of tests/test_checkpoint_data.py
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tcfg = t_get_arch("qwen2-0.5b").reduced().with_(remat="none",
                                                    n_layers=1)
    state = AsyncTrainer(tcfg, async_cfg=AsyncConfig(1),
                         device="cpu").init_state(0)
    save(str(tmp_path / "ck"), state, step=7, meta={"arch": tcfg.name})
    restored = restore(str(tmp_path / "ck"), tree_map(torch.zeros_like,
                                                      state))
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = load_meta(str(tmp_path / "ck"))
    assert meta["step"] == 7 and meta["arch"] == tcfg.name


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(str(tmp_path / "ck"), {"w": torch.ones((3, 3))})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "ck"), {"w": torch.ones((2, 3))})


def test_checkpoint_save_is_atomic_and_verifiable(tmp_path):
    ck = str(tmp_path / "ck")
    save(ck, {"w": torch.arange(6.0).reshape(2, 3),
              "b": torch.ones(4, dtype=torch.bfloat16)}, step=3)
    assert sorted(os.listdir(ck)) == ["meta.json", "state.npz"]
    info = verify(ck)
    assert info["step"] == 3
    assert info["state_nbytes"] == os.path.getsize(
        os.path.join(ck, "state.npz"))
    assert len(info["state_sha256"]) == 64
    assert info["keys"] == ["['w']", "__bf16__['b']"]


def test_checkpoint_truncated_state_fails_loudly(tmp_path):
    ck = str(tmp_path / "ck")
    save(ck, {"w": torch.ones((32, 32))})
    sp = os.path.join(ck, "state.npz")
    with open(sp, "r+b") as f:
        f.truncate(os.path.getsize(sp) // 2)
    with pytest.raises(CheckpointError, match="truncated|torn"):
        verify(ck)
    with pytest.raises(CheckpointError):
        restore(ck, {"w": torch.ones((32, 32))})


def test_checkpoint_digest_mismatch_fails_loudly(tmp_path):
    ck = str(tmp_path / "ck")
    save(ck, {"w": torch.ones((32, 32))})
    sp = os.path.join(ck, "state.npz")
    with open(sp, "r+b") as f:
        f.seek(os.path.getsize(sp) - 100)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointError, match="sha256"):
        verify(ck)
    with pytest.raises(CheckpointError, match="sha256"):
        restore(ck, {"w": torch.ones((32, 32))})


def test_checkpoint_missing_halves_fail_loudly(tmp_path):
    ck = str(tmp_path / "ck")
    save(ck, {"w": torch.ones(3)})
    os.remove(os.path.join(ck, "meta.json"))
    with pytest.raises(CheckpointError, match="meta.json"):
        verify(ck)
    save(ck, {"w": torch.ones(3)})
    os.remove(os.path.join(ck, "state.npz"))
    with pytest.raises(CheckpointError, match="state.npz"):
        verify(ck)
    save(ck, {"w": torch.ones(3)})
    with pytest.raises(CheckpointError, match="absent"):
        restore(ck, {"w": torch.ones(3), "extra": torch.ones(2)})


def test_snapshotter_latest_skips_corrupt_dirs(tmp_path):
    root = str(tmp_path / "snaps")
    save(os.path.join(root, "round-00000004"), {"w": torch.ones(3)}, step=4)
    save(os.path.join(root, "round-00000008"), {"w": torch.ones(3)}, step=8)
    os.makedirs(os.path.join(root, "not-a-round"))
    r, d = AsyncSnapshotter.latest(root)
    assert r == 8 and d.endswith("round-00000008")
    with open(os.path.join(root, "round-00000008", "state.npz"), "r+b") as f:
        f.truncate(10)
    r, d = AsyncSnapshotter.latest(root)
    assert r == 4 and d.endswith("round-00000004")
    os.remove(os.path.join(root, "round-00000004", "meta.json"))
    assert AsyncSnapshotter.latest(root) is None


# ---------------------------------------------------------------------------
# the snapshotter
# ---------------------------------------------------------------------------
def test_snapshotter_validation_and_cadence(tmp_path):
    with pytest.raises(ValueError, match="cadence"):
        AsyncSnapshotter(str(tmp_path), 0)
    with pytest.raises(ValueError, match="keep"):
        AsyncSnapshotter(str(tmp_path), 4, keep=0)
    # a recorder is taken now (its spans: tests/test_torch_obs.py)
    assert AsyncSnapshotter(str(tmp_path), 4,
                            recorder=object()).recorder is not None
    s = AsyncSnapshotter(str(tmp_path), 4)
    assert s.due(4, 12) and s.due(8, 12) and s.due(12, 12)
    assert not s.due(6, 12)
    assert s.due(10, 10)
    assert AsyncSnapshotter.latest(str(tmp_path / "no-such-dir")) is None
    assert s.drain() is None


def test_snapshotter_keeps_k_writes_one_behind_and_isolates(tmp_path):
    """Each offer writes the one before (two deep); keep=2 prunes to the
    newest two; an in-place update after ``offer`` leaves the snapshot as
    it was offered."""
    snap = AsyncSnapshotter(str(tmp_path), 1, keep=2, meta={"arch": "m"})
    w = torch.zeros(5, dtype=torch.bfloat16)
    for r in (1, 2, 3):
        w.fill_(r)
        snap.offer(r, {"w": w, "step": torch.tensor(r, dtype=torch.int32)},
                   meta={"note": r})
        w.add_(100)                       # the next chunk, in place
        written = sorted(d for d in os.listdir(tmp_path))
        assert written == [f"round-{x:08d}" for x in range(max(1, r - 2), r)]
    assert snap.drain() == 3
    assert sorted(os.listdir(tmp_path)) == ["round-00000002",
                                            "round-00000003"]
    for r in (2, 3):
        d = snap.round_dir(r)
        got = restore(d, {"w": torch.empty(5, dtype=torch.bfloat16),
                          "step": torch.zeros((), dtype=torch.int32)})
        assert torch.equal(got["w"], torch.full((5,), float(r),
                                                dtype=torch.bfloat16))
        meta = load_meta(d)
        assert (meta["round"], meta["step"], meta["kind"]) == \
            (r, r, "snapshot")
        assert (meta["arch"], meta["note"]) == ("m", r)
    assert AsyncSnapshotter.latest(str(tmp_path))[0] == 3


# ---------------------------------------------------------------------------
# training: snapshot, resume, SIGKILL
# ---------------------------------------------------------------------------
#: the snapshotted training world (importable by the writer subprocess)
TRAIN_T, TRAIN_K = 12, 4


def _train_world():
    job = TrainJob(global_batch=4, seq_len=16, update_impl="pallas",
                   arch_overrides=(("n_layers", 1),))
    spec = ExperimentSpec(objective=job, n_workers=2, T=TRAIN_T,
                          stepsize=1e-2, rounds_per_launch=TRAIN_K)
    tr = AsyncTrainer(job.make_arch(),
                      opt=OptConfig(lr=1e-2, update_impl="pallas"),
                      async_cfg=AsyncConfig(delay_rounds=1), device="cpu")
    tr.n_groups = 2
    _, schedule = TrainerBackend.masks_for(spec, 2)
    plan = compile_plan(schedule, job, rounds=TRAIN_T, n_groups=2, seed=0)
    return tr, plan


def _assert_same_state(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_snapshotted_run_resumes_bitwise_at_a_chunk_boundary(tmp_path):
    tr, plan = _train_world()
    ex = PlanExecutor(tr, plan)
    snapdir = str(tmp_path / "snaps")
    snap = AsyncSnapshotter(snapdir, TRAIN_K, keep=2, meta={"arch": "micro"})
    full = ex.run_scan(tr.init_state(0), rounds_per_launch=TRAIN_K,
                       metrics="none", snapshot=snap)
    assert full.stats.snapshots == 3              # boundaries 4, 8, 12
    assert full.stats.host_syncs == 0
    assert sorted(os.listdir(snapdir)) == ["round-00000008",
                                           "round-00000012"]
    r, latest = AsyncSnapshotter.latest(snapdir)
    assert r == 12
    meta = load_meta(latest)
    assert (meta["kind"], meta["round"], meta["arch"]) == \
        ("snapshot", 12, "micro")
    _assert_same_state(full.state, restore(latest, tr.init_state(0)))

    restored = restore(os.path.join(snapdir, "round-00000008"),
                       tr.init_state(0))
    assert int(restored["step"]) == 8
    tail = ex.run_scan(restored, rounds_per_launch=TRAIN_K, metrics="none",
                       start_round=8)
    assert tail.launches == 1
    _assert_same_state(full.state, tail.state)
    # the chunk transport with its per-chunk callback snapshots the same
    seen = []
    cb = ex.run_scan(tr.init_state(0), rounds_per_launch=TRAIN_K,
                     on_step=lambda i, s, m: seen.append(i),
                     snapshot=AsyncSnapshotter(str(tmp_path / "cb"), 8))
    assert cb.stats.snapshots == 2 and seen == list(range(TRAIN_T))
    _assert_same_state(full.state, cb.state)


def test_trainer_backend_snapshot_knob(tmp_path):
    job = TrainJob(global_batch=4, seq_len=16, update_impl="pallas",
                   arch_overrides=(("n_layers", 1),))
    spec = ExperimentSpec(objective=job, n_workers=2, T=4, stepsize=1e-2,
                          rounds_per_launch=2)
    res = TrainerBackend("cpu", snapshot=AsyncSnapshotter(
        str(tmp_path / "s"), 2)).run(spec)
    assert res.extra["snapshots"] == 2
    assert AsyncSnapshotter.latest(str(tmp_path / "s"))[0] == 4
    eager = TrainerBackend("cpu", runtime="eager", snapshot=AsyncSnapshotter(
        str(tmp_path / "e"), 2)).run(spec)
    assert eager.extra["snapshots"] == 0          # scan-only, as in JAX
    # the divergence breaker is taken now (it trips through the tap lane:
    # tests/test_torch_tap_grid.py)
    br = DivergenceBreaker()
    assert TrainerBackend("cpu", breaker=br).breaker is br


_TRAIN_CHILD = """
import sys, time
sys.path.insert(0, {tests!r})
from test_torch_checkpoint import _train_world, TRAIN_K
from repro_torch.checkpoint import AsyncSnapshotter
from repro_torch.runtime import PlanExecutor
tr, plan = _train_world()
ex = PlanExecutor(tr, plan)
ex.run_scan(tr.init_state(0), rounds_per_launch=TRAIN_K,
            on_step=lambda i, s, m: time.sleep(0.25),
            snapshot=AsyncSnapshotter(sys.argv[1], TRAIN_K, keep=3))
print("FINISHED", flush=True)
"""


def _kill_after_first_snapshot(code, snapdir):
    """Run ``code`` in a subprocess, SIGKILL it once ``snapdir`` holds a
    restorable snapshot; returns the child's stdout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", ""))
        if p))
    child = subprocess.Popen([sys.executable, "-c", code, snapdir], env=env,
                             cwd=str(ROOT), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        found = None
        while time.time() < deadline and child.poll() is None:
            found = AsyncSnapshotter.latest(snapdir)
            if found is not None:
                break
            time.sleep(0.05)
        assert found is not None, (
            "the child wrote no snapshot:\n" + child.communicate()[1])
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    return child.stdout.read() if child.stdout else ""


def test_sigkill_training_crash_resume_gate(tmp_path):
    """A subprocess training with snapshots is SIGKILLed mid-run; the
    newest restorable snapshot resumes to the uninterrupted run's state,
    bit for bit."""
    snapdir = str(tmp_path / "crash")
    out = _kill_after_first_snapshot(
        _TRAIN_CHILD.format(tests=str(ROOT / "tests")), snapdir)
    assert "FINISHED" not in out, "the child finished before the kill"
    r, latest = AsyncSnapshotter.latest(snapdir)
    assert 0 < r < TRAIN_T and r % TRAIN_K == 0
    tr, plan = _train_world()
    ex = PlanExecutor(tr, plan)
    full = ex.run_scan(tr.init_state(0), rounds_per_launch=TRAIN_K)
    tail = ex.run_scan(restore(latest, tr.init_state(0)),
                       rounds_per_launch=TRAIN_K, start_round=r)
    _assert_same_state(full.state, tail.state)
    np.testing.assert_array_equal(full.metrics["loss"][r:],
                                  tail.metrics["loss"])
