"""Scheduler parity vs torch, checkpoint round-trip, blend weights, trainer step."""

import numpy as np
import pytest

from tomosar2height_jax.infer.generator import linear_blend_weight
from tomosar2height_jax.train.checkpoint import CheckpointIO
from tomosar2height_jax.train.schedule import (
    CosineAnnealingLR,
    CosineAnnealingWarmRestarts,
    CyclicLR,
    ReduceLROnPlateau,
    build_scheduler,
)

torch = pytest.importorskip("torch")


def _torch_lrs(sched_cls, kwargs, n, metric_seq=None):
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=kwargs.get("base_lr", kwargs.get("lr", 1e-4)))
    ts = sched_cls(opt, **kwargs)
    lrs = []
    for i in range(n):
        lrs.append(opt.param_groups[0]["lr"])
        if metric_seq is not None:
            ts.step(metric_seq[i])
        else:
            ts.step()
    return lrs


class TestSchedulers:
    def test_cyclic_triangular2_matches_torch(self):
        kwargs = dict(base_lr=1e-4, max_lr=5e-4, step_size_up=5, step_size_down=5,
                      mode="triangular2", cycle_momentum=False)
        want = _torch_lrs(torch.optim.lr_scheduler.CyclicLR, kwargs, 25)
        s = CyclicLR(**kwargs)
        got = []
        for _ in range(25):
            got.append(s.lr)
            s.step()
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_cosine_matches_torch(self):
        p = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([p], lr=1e-3)
        ts = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=10)
        want = []
        for _ in range(15):
            want.append(opt.param_groups[0]["lr"])
            ts.step()
        s = CosineAnnealingLR(base_lr=1e-3, T_max=10)
        got = []
        for _ in range(15):
            got.append(s.lr)
            s.step()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)

    def test_warm_restarts_matches_torch(self):
        p = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([p], lr=1e-3)
        ts = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=4, T_mult=2)
        want = []
        for i in range(20):
            want.append(opt.param_groups[0]["lr"])
            ts.step(i + 1)
        s = CosineAnnealingWarmRestarts(base_lr=1e-3, T_0=4, T_mult=2)
        got = []
        for _ in range(20):
            got.append(s.lr)
            s.step()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)

    def test_plateau_decays(self):
        s = ReduceLROnPlateau(base_lr=1e-3, factor=0.5, patience=1)
        for m in [1.0, 0.9, 0.9, 0.9]:  # 2 bad epochs after the improvement
            s.step(m)
        assert s.lr == pytest.approx(5e-4)

    def test_build_from_config(self):
        cfg = {"learning_rate": 1e-4,
               "scheduler": {"type": "CyclicLR",
                             "kwargs": {"base_lr": 1e-4, "max_lr": 5e-4, "mode": "triangular2",
                                        "gamma": 1.0, "step_size_up": 500,
                                        "step_size_down": 500, "cycle_momentum": False}}}
        s = build_scheduler(cfg)
        assert isinstance(s, CyclicLR) and s.lr == pytest.approx(1e-4)
        sd = s.state_dict()
        s.step()
        s.load_state_dict(sd)
        assert s.last_step == 0


class TestBlendWeight:
    def test_matches_reference_formula(self):
        w = linear_blend_weight((8, 8), [0.5, 0.5])
        assert w.dtype == np.float64
        assert w.max() <= 1.0 and w.min() >= 1e-6
        # center is 1 (both ramps peak), corner is MIN_WEIGHT^2
        np.testing.assert_allclose(w[0, 0], 1e-3 * 1e-3)
        np.testing.assert_allclose(w[3, 3], 1.0)
        # symmetric
        np.testing.assert_allclose(w, w[::-1, ::-1])

    def test_no_blend(self):
        w = linear_blend_weight((4, 4), [0.0, 0.0])
        np.testing.assert_array_equal(w, np.ones((4, 4)))

    def test_asserts(self):
        with pytest.raises(AssertionError):
            linear_blend_weight((4, 4), [0.7, 0.5])


class TestCheckpointIO:
    def test_roundtrip_with_scalars_and_scheduler(self, tmp_path):
        import jax.numpy as jnp

        params = {"w": jnp.arange(4.0), "b": jnp.zeros(2)}
        sched = CyclicLR(base_lr=1e-4, max_lr=5e-4, step_size_up=3)
        sched.step(); sched.step()
        io = CheckpointIO(str(tmp_path), model=params, scheduler=sched)
        path = str(tmp_path / "model_7.ckpt")
        io.save(path, n_iter=7, loss_val_best=0.5, training_time=12.0)

        params2 = {"w": jnp.zeros(4), "b": jnp.ones(2)}
        sched2 = CyclicLR(base_lr=1e-4, max_lr=5e-4, step_size_up=3)
        io2 = CheckpointIO(str(tmp_path), model=params2, scheduler=sched2)
        scalars = io2.load(path)
        assert scalars["n_iter"] == 7
        assert scalars["loss_val_best"] == 0.5
        np.testing.assert_array_equal(np.asarray(io2.module_dict["model"]["w"]),
                                      np.arange(4.0))
        assert sched2.last_step == 2

    def test_missing_file(self, tmp_path):
        io = CheckpointIO(str(tmp_path), model={})
        with pytest.raises(FileNotFoundError):
            io.load(str(tmp_path / "nope.ckpt"))

    def test_skip_scheduler(self, tmp_path):
        sched = CyclicLR(base_lr=1e-4, max_lr=5e-4, step_size_up=3)
        io = CheckpointIO(str(tmp_path), scheduler=sched)
        path = str(tmp_path / "m.ckpt")
        io.save(path, n_iter=1)
        sched.step()
        out = io.load(path, resume_scheduler=False)
        assert sched.last_step == 1  # untouched
        assert out["n_iter"] == 1

    def test_url_loading(self, tmp_path):
        """http(s) checkpoint URLs download into the checkpoint dir and load
        (reference io_checkpoint.py:78-88)."""
        import http.server
        import threading

        import jax.numpy as jnp

        src_dir = tmp_path / "remote"
        src_dir.mkdir()
        params = {"w": jnp.arange(3.0)}
        CheckpointIO(str(src_dir), model=params).save(
            str(src_dir / "model_url.ckpt"), n_iter=9)

        handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(
            *a, directory=str(src_dir), **kw)
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/model_url.ckpt"
            dst_dir = tmp_path / "local"
            io2 = CheckpointIO(str(dst_dir), model={"w": jnp.zeros(3)})
            scalars = io2.load(url)
            assert scalars["n_iter"] == 9
            np.testing.assert_array_equal(np.asarray(io2.module_dict["model"]["w"]),
                                          np.arange(3.0))
            assert (dst_dir / "model_url.ckpt").exists()  # cached
            # second load hits the cache (server could be gone)
            srv.shutdown()
            scalars = io2.load(url)
            assert scalars["n_iter"] == 9
        finally:
            srv.shutdown()


class TestMetricLoggerWatch:
    def test_watch_emits_param_norms(self, tmp_path):
        import json

        from tomosar2height_jax.utils import MetricLogger

        params = {"params": {"enc": {"w": np.ones((2, 2), np.float32)},
                             "dec": {"b": np.full((4,), 3.0, np.float32)}}}
        lg = MetricLogger().init("p", {}, "run", str(tmp_path))
        lg.watch(lambda: params, log_freq=2)
        lg.log({"loss": 1.0}, step=1)   # not a watch step
        lg.log({"loss": 0.5}, step=2)   # watch step
        lg.finish()
        recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
        step1 = next(r for r in recs if r.get("_step") == 1)
        step2 = next(r for r in recs if r.get("_step") == 2)
        assert "watch/param_norm/enc" not in step1
        assert step2["watch/param_norm/enc"] == pytest.approx(2.0)
        assert step2["watch/param_norm/dec"] == pytest.approx(6.0)

    def test_watch_norms_fn_precomputed(self, tmp_path):
        """Production path: norms precomputed on device (Trainer.module_norms)
        — the logger consumes scalars and never touches the param tree."""
        import json

        from tomosar2height_jax.utils import MetricLogger

        calls = []

        def norms():
            calls.append(1)
            return {"enc": 2.0, "dec": 6.0}

        lg = MetricLogger().init("p", {}, "run", str(tmp_path))
        lg.watch(norms_fn=norms, log_freq=2)
        lg.log({"loss": 1.0}, step=1)   # not a watch step
        lg.log({"loss": 0.5}, step=2)   # watch step
        lg.finish()
        assert len(calls) == 1          # only invoked at watch cadence
        recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
        step1 = next(r for r in recs if r.get("_step") == 1)
        step2 = next(r for r in recs if r.get("_step") == 2)
        assert "watch/param_norm/enc" not in step1
        assert step2["watch/param_norm/enc"] == pytest.approx(2.0)
        assert step2["watch/param_norm/dec"] == pytest.approx(6.0)
