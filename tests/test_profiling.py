"""Profiling utils + remat flag tests."""

import numpy as np

import jax
import jax.numpy as jnp

from tomosar2height_jax.utils.profiling import (
    PhaseTimer,
    device_trace,
    hlo_op_scopes,
    scope_device_times,
)


class TestPhaseTimer:
    def test_accumulates(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        s = t.summary()
        assert s["time/a_total_s"] >= 0 and "time/a_mean_ms" in s
        assert t.counts["a"] == 2 and t.counts["b"] == 1
        t.reset()
        assert not t.totals

    def test_device_trace_noop(self, tmp_path):
        with device_trace(None):
            pass
        with device_trace(str(tmp_path / "trace")):
            jnp.ones(4).sum()


class TestRemat:
    def test_remat_same_output_and_grads(self, rng):
        from tomosar2height_jax.models import TomoSAR2Height

        pts = jnp.asarray(rng.uniform(0.01, 0.99, (1, 256, 3)).astype(np.float32))
        mask = jnp.ones((1, 256), bool)
        kwargs = dict(
            encoder_kwargs={
                "feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "start_filts": 8, "merge_mode": "concat"},
            },
            decoder_kwargs={"hidden_dim": 8, "output_size": 64},
            z_scale=60.0,
        )
        m0 = TomoSAR2Height(remat=False, **kwargs)
        m1 = TomoSAR2Height(remat=True, **kwargs)
        params = m0.init(jax.random.PRNGKey(0), pts, mask, None)
        # remat must not change the parameter structure
        p1 = jax.eval_shape(lambda: m1.init(jax.random.PRNGKey(0), pts, mask, None))
        assert jax.tree.structure(params) == jax.tree.structure(p1)

        def loss(m, p):
            pa, _ = m.apply(p, pts, mask, None)
            return (pa ** 2).mean()

        l0, g0 = jax.value_and_grad(lambda p: loss(m0, p))(params)
        l1, g1 = jax.value_and_grad(lambda p: loss(m1, p))(params)
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


class TestCompileCache:
    def test_cpu_backend_never_enables_persistent_cache(self, tmp_path):
        """Persistently-cached XLA:CPU AOT executables carry machine features
        across hosts (cpu_aot_loader mismatch -> intermittent SIGABRT mid-
        suite). enable_compile_cache must be a no-op on the CPU backend."""
        import jax

        from tomosar2height_jax.utils import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        min_before = jax.config.jax_persistent_cache_min_compile_time_secs
        enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == before
        assert jax.config.jax_persistent_cache_min_compile_time_secs == min_before


class TestScopeReduction:
    SCOPES = ("point_pool", "plane_scatter", "alto_round_trip/gather",
              "alto_round_trip/mlp", "alto_round_trip/scatter_mean")

    def test_hlo_op_scopes_reads_metadata(self):
        text = "\n".join([
            "HloModule jit_f",
            "ENTRY %main {",
            "  %p = f32[4] parameter(0)",
            '  %fusion.1 = f32[4] fusion(%p), kind=kLoop, calls=%fc, metadata='
            '{op_name="jit(f)/jit(main)/point_encoder/point_pool/scatter-add" '
            'source_file="x.py" source_line=3}',
            '  ROOT dot.2 = f32[] dot(%p, %p), metadata={op_name='
            '"transpose(jvp(jit(f)))/unet/alto_round_trip/mlp/fc_comm/dot_general"}',
            '  %other = f32[] add(%p, %p), metadata={op_name="jit(f)/point_pooling/add"}',
            "  %input_scatter_fusion.2 = f32[4] fusion(%p), kind=kInput, "
            "calls=%fused_scatter.2",
            "}",
            "%fused_scatter.2 (param_0: f32[4]) -> f32[4] {",
            '  ROOT %s = f32[4] scatter(...), metadata={op_name='
            '"jit(f)/alto_round_trip/scatter_mean/scatter-add"}',
            "}",
        ])
        # keys are kernel names; a fusion without metadata takes its body's scope
        assert hlo_op_scopes(text, self.SCOPES) == {
            "fusion_1": "point_pool", "dot_2": "alto_round_trip/mlp",
            "input_scatter_fusion_2": "alto_round_trip/scatter_mean",
            "s": "alto_round_trip/scatter_mean"}

    def test_trace_of_small_model_is_attributed(self, tmp_path):
        from tomosar2height_jax.models import TomoSAR2Height

        model = TomoSAR2Height(
            encoder_kwargs={"feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
                            "unet_type": "alto",
                            "unet_kwargs": {"depth": 3, "start_filts": 8}},
            decoder_kwargs={"hidden_dim": 8, "output_size": 64}, z_scale=60.0)
        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(0.01, 0.99, (2, 512, 3)).astype(np.float32))
        mask = jnp.ones((2, 512), bool)
        params = model.init(jax.random.PRNGKey(0), pts, mask)
        fwd = jax.jit(lambda p, x, m: model.apply(p, x, m)[0].sum())
        fwd(params, pts, mask).block_until_ready()
        hlo = fwd.lower(params, pts, mask).compile().as_text()
        op_scopes = hlo_op_scopes(hlo, self.SCOPES)
        assert set(op_scopes.values()) == set(self.SCOPES)
        with jax.profiler.trace(str(tmp_path)):
            for _ in range(3):
                fwd(params, pts, mask).block_until_ready()
        times = scope_device_times(str(tmp_path), op_scopes)
        total = times.pop("__device_total__")
        assert total > 0 and "point_pool" in times and "other" in times
        assert all(v >= 0 for v in times.values())
