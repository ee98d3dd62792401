"""Fused unbalanced-Sinkhorn kernel for the GPU (Pallas through Triton).

The XLA lowering of the fixed-K Sinkhorn loop (association._sinkhorn_
unbalanced) is a pair of (N, K=8) mat-vecs plus `pow` per iteration: at 50
iterations x 2 GN rounds per scan that is on the order of a few hundred tiny
kernel launches and while-loop trips per scan, with almost no arithmetic in
any of them. Here the whole loop runs in ONE program per problem: the (K, N)
kernel matrix exp(-C/eps) is computed once and stays resident in the block's
registers (an (8, 2048) f32 tile is 64 KB), and the 50 iterations are an
in-kernel loop of two axis reductions and two `pow`s each. No tensor cores:
K=8 is far below the 64-row `wgmma` tile.

Layout: the kernel works on the TRANSPOSED (K, N) cost. Triton blocks are
powers of two, so N and K are padded up with zero-mass entries (a=0 / b=0,
cost 1e12 -> exp(-C/eps) = 0), which contribute exactly zero to every
reduction and come out as exactly zero transport. Under `jax.vmap` (the
K_HYP hypothesis axis) Pallas adds a grid axis: one program per hypothesis.

Math parity with association._sinkhorn_unbalanced (reference
operators/primitive_association.py:432-505): K_mat = exp(-C/eps);
u <- (a / (K v))^ua, v <- (b / (K^T u))^vb, fixed n_iters, no convergence
check; returns pi = diag(u) K diag(v). Same guards (1e-12 denominators).
The kernel computes in float32; `resolve_backend` keeps float64 problems on
the XLA loop.
"""

from __future__ import annotations

import functools

from gcslam_tpu.utils.xla import jax, jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BACKENDS = ("auto", "xla", "pallas")


def resolve_backend(requested: str, platform: str, dtype) -> str:
    """The Sinkhorn backend a problem of `dtype` runs on `platform`.

    "auto" is the kernel on the GPU in float32 and the XLA loop otherwise
    (float64 problems, the CPU). A forced "pallas" that cannot be honoured is
    an error, never a silent interpretation or precision downgrade."""
    if requested not in BACKENDS:
        raise ValueError(f"sinkhorn_backend={requested!r} not in {BACKENDS}")
    f32 = jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    if requested == "auto":
        return "pallas" if platform == "gpu" and f32 else "xla"
    if requested == "pallas":
        if platform != "gpu":
            raise ValueError(
                f"sinkhorn_backend='pallas' needs a GPU; this process runs on "
                f"{platform!r} (use 'auto' or 'xla')")
        if not f32:
            raise ValueError(
                f"sinkhorn_backend='pallas' computes in float32; the problem is "
                f"{jnp.dtype(dtype)} (use 'auto' or 'xla')")
    return requested


def _num_warps(n_elems: int) -> int:
    # ~32 resident tile elements per thread, 4..16 warps per block
    return int(min(16, max(4, n_elems // (32 * 32))))


def _kernel(scal_ref, cost_t_ref, a_ref, b_ref, pi_t_ref, *, n_iters: int):
    eps = scal_ref[0]
    ua = scal_ref[1]
    vb = scal_ref[2]
    K_mat = jnp.exp(-cost_t_ref[...] / eps)  # (Kp, Np), resident
    a = a_ref[...]  # (Np,)
    b = b_ref[...]  # (Kp,)

    def it(_, uv):
        u, v = uv  # (Np,), (Kp,)
        Kv = jnp.sum(K_mat * v[:, None], axis=0)  # (Np,)
        u = jnp.power(a / (Kv + 1e-12), ua)
        Ktu = jnp.sum(K_mat * u[None, :], axis=1)  # (Kp,)
        v = jnp.power(b / (Ktu + 1e-12), vb)
        return u, v

    u, v = jax.lax.fori_loop(0, n_iters, it, (jnp.ones_like(a), jnp.ones_like(b)))
    pi_t_ref[...] = u[None, :] * K_mat * v[:, None]


@functools.partial(jax.jit, static_argnames=("n_iters", "interpret"))
def sinkhorn_unbalanced_pallas(
    C_mat: jnp.ndarray,  # (N, K) cost
    a: jnp.ndarray,  # (N,) row marginals
    b: jnp.ndarray,  # (K,) column marginals
    epsilon,
    tau_a,
    tau_b,
    n_iters: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Drop-in replacement for association._sinkhorn_unbalanced.

    `interpret=True` runs the kernel in the Pallas interpreter (any backend);
    tests use it. Otherwise it compiles for the GPU through Triton."""
    N, K = C_mat.shape
    dt = C_mat.dtype
    f32 = jnp.float32
    eps = jnp.maximum(jnp.asarray(epsilon, f32), 1e-12)
    ua = 1.0 / (1.0 + jnp.asarray(tau_a, f32) / eps)
    vb = 1.0 / (1.0 + jnp.asarray(tau_b, f32) / eps)
    scal = jnp.stack([eps, ua, vb, jnp.zeros((), f32)])

    Np = pl.next_power_of_2(N)
    Kp = pl.next_power_of_2(K)
    C_t = jnp.pad(C_mat.astype(f32).T, ((0, Kp - K), (0, Np - N)),
                  constant_values=1e12)  # (Kp, Np)
    a_p = jnp.pad(a.astype(f32), (0, Np - N))
    b_p = jnp.pad(b.astype(f32), (0, Kp - K))

    pi_t = pl.pallas_call(
        functools.partial(_kernel, n_iters=n_iters),
        out_shape=jax.ShapeDtypeStruct((Kp, Np), f32),
        grid=(),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(Kp * Np), num_stages=1),
        interpret=interpret,
        name="sinkhorn_unbalanced",
    )(scal, C_t, a_p, b_p)
    return pi_t[:K, :N].T.astype(dt)
