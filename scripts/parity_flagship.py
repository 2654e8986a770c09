#!/usr/bin/env python
"""One-off torch-parity run at the FLAGSHIP shape.

The CI harness (tests/test_reference_parity.py) pins forward parity at
reduced shapes (32^2 plane / depth 4 / 64^2 output). This script runs the
same ported-weight comparison once at the reference's shipped configuration
(/root/reference/conf/model/tomosar2height.yaml: 256^2 plane, ALTO depth 5,
image U-Net depth 6, 512^2 decoder output, 16k-point patch) — slow on CPU
torch, so it lives here rather than in the suite. Run:

    python scripts/parity_flagship.py            # cloud+image+footprint
    python scripts/parity_flagship.py --no-image # cloud-only
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-image", action="store_true")
    ap.add_argument("--points", type=int, default=16384)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    import torch
    import jax.numpy as jnp
    from tomosar2height_jax.models import TomoSAR2Height
    import test_reference_parity as harness

    # import the reference with the harness's dependency shims
    class _Req:
        def __init__(self):
            self._done = None
    sys.modules.setdefault("torch_scatter", harness._shim_torch_scatter())
    import types
    for name in ("open3d", "laspy", "rasterio"):
        sys.modules.setdefault(name, types.ModuleType(name))
    o3d = sys.modules["open3d"]
    if not hasattr(o3d, "geometry"):
        o3d.geometry = types.SimpleNamespace(PointCloud=object)
        o3d.utility = types.SimpleNamespace(Vector3dVector=object)
    rio = sys.modules["rasterio"]
    rt = types.ModuleType("rasterio.transform")
    rt.Affine = object
    rio.transform = rt
    rio.DatasetReader = object
    rio.io = types.SimpleNamespace(DatasetWriter=object)
    sys.modules.setdefault("rasterio.transform", rt)
    if harness.REFERENCE_ROOT not in sys.path:
        sys.path.append(harness.REFERENCE_ROOT)
    import tomosar2height.model as ref_model

    use_image = not args.no_image
    use_fp = use_image

    enc_kwargs = dict(
        feature_dim=32, hidden_dim=32, scatter_type="max",
        unet_type="alto", plane_resolution=256,
        unet_kwargs=dict(depth=5, start_filts=32, merge_mode="concat"),
    )
    cfg = harness._Cfg(
        use_cloud=True, use_image=use_image,
        model=dict(
            data_dim=3, encoder="pointnet_local_pool",
            encoder_kwargs=dict(enc_kwargs),
            encoder2="unet",
            encoder2_kwargs=dict(num_classes=32, in_channels=3, depth=6,
                                 start_filts=32),
            decoder_pixel_kwargs=dict(hidden_dim=32, out_dim=1,
                                      output_size=512, mode="conv",
                                      use_footprint=use_fp),
        ),
        test=dict(threshold=0.5),
        dataset=dict(normalize=dict(z_bound=[0.0, 60.0])),
    )
    torch.manual_seed(0)
    ref = ref_model.TomoSAR2Height(cfg)
    ref.eval()

    model = TomoSAR2Height(
        use_cloud=True, use_image=use_image,
        encoder_kwargs=dict(enc_kwargs),
        encoder2_kwargs=dict(num_classes=32, depth=6, start_filts=32),
        decoder_kwargs=dict(hidden_dim=32, out_dim=1, output_size=512,
                            mode="conv", use_footprint=use_fp),
        z_scale=60.0,
    )

    rng = np.random.default_rng(7)
    pts = rng.uniform(0.01, 0.99, (1, args.points, 3)).astype(np.float32)
    img = rng.normal(size=(1, 512, 512, 3)).astype(np.float32)
    points = jnp.asarray(pts)
    mask = jnp.ones(pts.shape[:2], bool)
    image = jnp.asarray(img) if use_image else None

    t0 = time.time()
    params = model.init(jax.random.PRNGKey(0), points, mask, image)
    params, unused = harness.port_torch_to_flax(ref, params)
    for k in unused:
        assert any(s in k for s in ("upconv.", "fc_comm", "fc_c")), k
    print(f"[{time.time()-t0:.1f}s] weights ported "
          f"({sum(x.size for x in jax.tree.leaves(params))/1e6:.2f} M params)")

    t0 = time.time()
    with torch.no_grad():
        pa_t, pb_t = ref(
            torch.from_numpy(pts),
            torch.from_numpy(img.transpose(0, 3, 1, 2)) if use_image else None,
        )
    print(f"[{time.time()-t0:.1f}s] torch reference forward")

    t0 = time.time()
    pa_j, pb_j = jax.jit(model.apply)(params, points, mask, image)
    pa_j = np.asarray(pa_j)
    print(f"[{time.time()-t0:.1f}s] jax forward (jit, cpu)")

    d_a = np.abs(pa_j - pa_t.numpy())
    print(f"dsm head: max abs err {d_a.max():.3e}  mean {d_a.mean():.3e}  "
          f"(|out| max {np.abs(pa_t.numpy()).max():.3f})")
    ok = d_a.max() < 5e-4
    if pb_t is not None:
        d_b = np.abs(np.asarray(pb_j) - pb_t.numpy())
        print(f"footprint head: max abs err {d_b.max():.3e}  mean {d_b.mean():.3e}")
        ok = ok and d_b.max() < 5e-4
    print("FLAGSHIP_PARITY_" + ("OK" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
