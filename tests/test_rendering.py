"""render_atlas: the top-mass splats of a device-resident atlas through the
scan compositor (outputs/rendering.render_splats)."""

import numpy as np

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.models.atlas import empty_atlas
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.outputs.rendering import RenderParams, render_atlas, render_splats


def test_render_atlas_draws_only_the_heaviest_valid_splats():
    rng = np.random.default_rng(11)
    cfg = PipelineConfig(atlas_max_tiles=2, m_tile=32, m_tile_view=16)
    atlas = empty_atlas(cfg)
    T, M = atlas.weights.shape
    n = 40  # valid slots; the rest stay empty
    mu = rng.uniform(-2, 2, (n, 3))
    mu[:, 2] = rng.uniform(2, 6, n)
    Lam = np.tile(np.eye(3) * 50.0, (n, 1, 1))
    flat = lambda x, fill: np.concatenate(
        [x, np.broadcast_to(fill, (T * M - n,) + x.shape[1:])]).reshape((T, M) + x.shape[1:])
    atlas = atlas._replace(
        Lambdas=jnp.asarray(flat(Lam, np.eye(3)), atlas.Lambdas.dtype),
        thetas=jnp.asarray(flat(np.einsum("pij,pj->pi", Lam, mu), 0.0), atlas.thetas.dtype),
        weights=jnp.asarray(flat(rng.uniform(1, 5, n), 0.0), atlas.weights.dtype),
        valid=jnp.asarray(flat(np.ones(n, bool), False)),
        rgb=jnp.asarray(flat(rng.uniform(0, 1, (n, 3)), 0.5), atlas.rgb.dtype),
    )
    params = RenderParams(width=64, height=48, fx=48.0, fy=48.0)
    cam = jnp.zeros(6)
    rgb, depth = render_atlas(atlas, cam, params, max_splats=16)
    rgb, depth = np.asarray(rgb), np.asarray(depth)
    assert rgb.shape == (48, 64, 3) and depth.shape == (48, 64)
    assert np.all(np.isfinite(rgb)) and np.all(np.isfinite(depth))
    assert (rgb.sum(-1) > 0.01).mean() > 0.05  # drew something

    # same picture as compositing the 16 heaviest splats directly
    w = np.asarray(atlas.weights).reshape(-1)
    top = np.argsort(-w, kind="stable")[:16]
    ti, si = top // M, top % M
    rgb2, depth2 = render_splats(
        jnp.asarray(mu[top], jnp.float32),
        jnp.asarray(np.linalg.inv(Lam[top]), jnp.float32),
        atlas.etas[ti, si], atlas.rgb[ti, si], jnp.asarray(w[top]), cam, params)
    np.testing.assert_allclose(rgb, np.asarray(rgb2), atol=1e-4)
