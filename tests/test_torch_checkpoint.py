"""The port's checkpoints and fault-tolerance helpers on the CPU: the
reference's atomicity, resume and async cases, and checkpoints of
``(params, opt_state)`` crossed between the packages in both
directions, every leaf bit-equal (the same on-disk layout and leaf
order)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.training import checkpoint as JCK
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import AdamWState as JAdamWState
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import ParamTree
from repro_torch.training import checkpoint as CK
from repro_torch.training.fault_tolerance import (Heartbeat, StragglerMonitor,
                                                  simulate_failure)
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.trees import flatten, items


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(7), "c": torch.tensor(3.5)}}


def _equal_trees(a, b):
    la, da = flatten(a)
    lb, db = flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


class TestAtomicCheckpoint:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        CK.save_checkpoint(str(tmp_path), 5, t)
        restored, step = CK.restore_checkpoint(str(tmp_path), t)
        assert step == 5
        _equal_trees(t, restored)

    def test_latest_points_to_newest(self, tmp_path):
        CK.save_checkpoint(str(tmp_path), 1, _tree(1))
        CK.save_checkpoint(str(tmp_path), 7, _tree(7))
        assert CK.latest_step(str(tmp_path)) == 7

    def test_prune_keeps_latest(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            CK.save_checkpoint(str(tmp_path), s, _tree(s))
        os.makedirs(tmp_path / "step_000000009.tmp")     # a dead write
        CK.prune_old(str(tmp_path), keep=2)
        assert CK.latest_step(str(tmp_path)) == 5
        assert sorted(os.listdir(tmp_path)) == [
            "LATEST", "step_000000004", "step_000000005",
            "step_000000009.tmp"]
        restored, _ = CK.restore_checkpoint(str(tmp_path), _tree())
        _equal_trees(restored, _tree(5))

    def test_shape_mismatch_rejected(self, tmp_path):
        CK.save_checkpoint(str(tmp_path), 1, _tree())
        bad = {"a": torch.zeros((3, 3)),
               "nested": {"b": torch.arange(7), "c": torch.tensor(0.0)}}
        with pytest.raises(ValueError, match="shape"):
            CK.restore_checkpoint(str(tmp_path), bad)
        with pytest.raises(ValueError, match="leaves"):
            CK.restore_checkpoint(str(tmp_path), {"a": torch.zeros(4, 8)})
        with pytest.raises(FileNotFoundError):
            CK.restore_checkpoint(str(tmp_path / "none"), _tree())

    def test_async_writer(self, tmp_path):
        ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in (10, 20, 30):
            ck.save(s, _tree(s))
        ck.close()
        assert CK.latest_step(str(tmp_path)) == 30
        assert sorted(os.listdir(tmp_path)) == [
            "LATEST", "step_000000020", "step_000000030"]

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """save() copies every leaf before it returns: an in-place update
        right after (the optimizer's) does not reach the checkpoint."""
        t = _tree(3)
        want = {"a": t["a"].clone()}
        ck = CK.AsyncCheckpointer(str(tmp_path))
        ck.save(1, t)
        t["a"].add_(100.0)
        ck.close()
        restored, _ = CK.restore_checkpoint(str(tmp_path), t)
        assert torch.equal(restored["a"], want["a"])

    def test_latest_is_written_last(self, tmp_path, monkeypatch):
        """A save that dies before LATEST moves leaves LATEST on the
        previous complete checkpoint."""
        CK.save_checkpoint(str(tmp_path), 1, _tree(1))
        real = os.replace

        def dying(src, dst):
            if dst.endswith("LATEST"):
                raise OSError("killed")
            return real(src, dst)

        monkeypatch.setattr(CK.os, "replace", dying)
        with pytest.raises(OSError):
            CK.save_checkpoint(str(tmp_path), 2, _tree(2))
        monkeypatch.setattr(CK.os, "replace", real)
        assert CK.latest_step(str(tmp_path)) == 1
        restored, step = CK.restore_checkpoint(str(tmp_path), _tree())
        assert step == 1
        _equal_trees(restored, _tree(1))

    def test_bfloat16_and_scalar_leaves(self, tmp_path):
        t = (ParamTree({"w": torch.randn(3, 4).bfloat16()}),
             AdamWState(7, {"w": torch.ones(3, 4)}, {"w": torch.zeros(3, 4)}),
             None, [2.5, True])
        CK.save_checkpoint(str(tmp_path), 3, t)
        with np.load(tmp_path / "step_000000003" / "arrays.npz") as d:
            assert d["a0"].dtype == np.float32
            assert d["a1"].dtype == np.int32 and d["a1"].shape == ()
        back, _ = CK.restore_checkpoint(str(tmp_path), t)
        assert isinstance(back[0], ParamTree)
        assert isinstance(back[1], AdamWState) and back[1].step == 7
        assert back[2] is None and back[3] == [2.5, True]
        _equal_trees(t, back)


# ---------------------------------------------------------------------------
# crossing packages
# ---------------------------------------------------------------------------


def _trained_pair(arch="yi-6b"):
    """The same (params, AdamW state) in both packages after one update
    of the reference's (non-zero moments, step 1)."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    opt = JAdamW(lr=1e-2)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5, p.dtype),
                                   jp)
    jp, js = opt.update(grads, opt.init(jp), jp)
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(tc, np_tree, device="cpu")
    ts = AdamWState(int(js.step),
                    jax.tree_util.tree_map(torch.as_tensor,
                                           jax.tree_util.tree_map(
                                               np.asarray, js.m)),
                    jax.tree_util.tree_map(torch.as_tensor,
                                           jax.tree_util.tree_map(
                                               np.asarray, js.v)))
    return tc, (jp, js), (tp, ts)


def _check_same(t_tree, j_tree):
    tl, _ = flatten(t_tree)
    jl = jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl)
    for x, y in zip(tl, jl):
        y = np.asarray(y)
        x = x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b"])
def test_port_restores_reference_checkpoint(tmp_path, arch):
    tc, (jp, js), _ = _trained_pair(arch)
    JCK.save_checkpoint(str(tmp_path), 1, (jp, js))
    fresh_p = params_from_jax(tc, jax.tree_util.tree_map(
        np.asarray, JM.init_params(j_get_config(arch).reduced(),
                                   jax.random.PRNGKey(9))), device="cpu")
    fresh_s = AdamW().init(fresh_p)
    (tp, ts), step = CK.restore_checkpoint(str(tmp_path), (fresh_p, fresh_s))
    assert step == 1 and ts.step == 1 and isinstance(tp, ParamTree)
    _check_same((tp, ts), (jp, js))


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium"])
def test_reference_restores_port_checkpoint(tmp_path, arch):
    _, (jp, js), (tp, ts) = _trained_pair(arch)
    CK.save_checkpoint(str(tmp_path), 1, (tp, ts))
    like = jax.tree_util.tree_map(jnp.zeros_like, (jp, js))
    (rp, rs), step = JCK.restore_checkpoint(str(tmp_path), like)
    assert step == 1 and int(rs.step) == 1
    _check_same((tp, ts), (rp, rs))
    # and the reference trains on from it
    opt = JAdamW(lr=1e-2)
    rp = jax.tree_util.tree_map(jnp.asarray, rp)
    rs = JAdamWState(jnp.asarray(rs.step),
                     jax.tree_util.tree_map(jnp.asarray, rs.m),
                     jax.tree_util.tree_map(jnp.asarray, rs.v))
    grads = jax.tree_util.tree_map(jnp.ones_like, rp)
    _, s2 = opt.update(grads, rs, rp)
    assert int(s2.step) == 2


def test_param_tree_leaf_order_is_sorted():
    """A ParamTree's insertion order is not sorted; checkpoints number
    leaves in sorted key order, as jax does."""
    t = ParamTree({"z": torch.zeros(1), "a": {"y": torch.ones(1),
                                              "b": torch.full((1,), 2.0)}})
    assert list(t.keys()) == ["z", "a"]
    assert [p for p, _ in items(t)] == [("a", "b"), ("a", "y"), ("z",)]
    leaves, _ = flatten((t, AdamWState(3, {"k": torch.zeros(1)}, {})))
    assert [float(x) if torch.is_tensor(x) else x for x in leaves] == \
        [2.0, 1.0, 0.0, 3, 0.0]


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


def test_straggler_detection():
    mon = StragglerMonitor(deadline_factor=2.0)
    for i in range(20):
        mon.record(i, 0.1)
    assert mon.record(20, 0.5)        # 5x median
    assert not mon.record(21, 0.11)
    assert len(mon.straggler_steps) == 1


def test_straggler_hook():
    seen = []
    mon = StragglerMonitor(on_straggler=lambda *a: seen.append(a))
    for i in range(10):
        mon.record(i, 1.0)
    mon.record(10, 4.0)
    assert seen == [(10, 4.0, 1.0)]


def test_heartbeat_liveness(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=3, interval_s=0.0)
    hb.beat(step=7)
    assert Heartbeat.dead_hosts(str(tmp_path), timeout_s=60) == []
    assert Heartbeat.dead_hosts(str(tmp_path), timeout_s=-1) == [3]


def test_simulate_failure_drops_the_tail():
    assert simulate_failure(["d0", "d1", "d2", "d3"], kill=1) == \
        ["d0", "d1", "d2"]
    assert simulate_failure(["d0"], kill=0) == ["d0"]
