"""Port parity: the pre-gathered SSpNNA tile stack of ``repro_torch``
(``sspnna_tiles``, whose CPU tensors run its plain version) against the JAX
package's Pallas kernel in interpret mode and its jnp oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sspnna.ref import sspnna_tile_ref as jax_tile_ref
from repro.kernels.sspnna.sspnna import sspnna_tiles as jax_sspnna_tiles
from repro_torch.kernels.sspnna.ref import (
    TILE_STACK_CASES,
    TILE_STACK_TOL,
    random_tile_stack,
    sspnna_tile_ref,
)
from repro_torch.kernels.sspnna.sspnna import sspnna_tiles, sspnna_tiles_plain

# tests/test_kernels.py's five-case sweep of the JAX kernel
JAX_SWEEP = TILE_STACK_CASES[:5]


def case_id(case):
    t, d_i, d_o, k, c, n, dt = case
    return f"t{t}i{d_i}o{d_o}k{k}c{c}n{n}-{str(dt).removeprefix('torch.')}"


def _jax(x: torch.Tensor):
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else None
    return jnp.asarray(x.float().numpy() if dt else x.numpy(), dt)


def _close(got: torch.Tensor, want, dtype):
    tol = TILE_STACK_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", TILE_STACK_CASES, ids=case_id)
def test_tiles_match_jax_kernel_and_oracle(case):
    """Random stacks with holes and all-hole tiles: the port against the
    JAX kernel (interpret mode) and the JAX oracle."""
    t, d_i, d_o, k, c, n, dt = case
    feats, idx, w = random_tile_stack(np.random.default_rng(t * d_i + c),
                                      t=t, d_i=d_i, d_o=d_o, k=k, c=c, n=n,
                                      dtype=dt)
    launches = sspnna_tiles.launches
    got = sspnna_tiles(feats, idx, w)
    assert sspnna_tiles.launches == launches  # CPU tensors: plain version
    assert got.shape == (t, d_o, n) and got.dtype == dt
    assert not got[0].any()  # tile 0 is all holes
    jargs = (_jax(feats), jnp.asarray(idx.numpy()), _jax(w))
    _close(got, jax_sspnna_tiles(*jargs, interpret=True), dt)
    _close(got, jax_tile_ref(*jargs), dt)


@pytest.mark.parametrize("case", JAX_SWEEP, ids=case_id)
def test_tiles_match_jax_on_its_own_sweep_inputs(case):
    """The JAX test's own input recipe: idx uniform in [-1, dI), weights
    scaled by 0.1."""
    t, d_i, d_o, k, c, n, dt = case
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(t, d_i, c)).astype(np.float32)).to(dt)
    idx = torch.from_numpy(rng.integers(-1, d_i, (t, d_o, k)).astype(np.int32))
    w = torch.from_numpy((rng.normal(size=(k, c, n)) * 0.1).astype(np.float32)).to(dt)
    got = sspnna_tiles(feats, idx, w)
    _close(got, jax_sspnna_tiles(_jax(feats), jnp.asarray(idx.numpy()),
                                 _jax(w), interpret=True), dt)


def test_plain_version_is_the_tile_oracle():
    assert sspnna_tiles_plain is sspnna_tile_ref


def test_all_hole_stack_is_zero():
    feats, idx, w = random_tile_stack(np.random.default_rng(1), t=3, d_i=8,
                                      d_o=4, k=27, c=4, n=8, hole_p=1.0)
    assert (idx < 0).all()
    assert not sspnna_tiles(feats, idx, w).any()


def test_tiles_wrapper_rejects_what_the_kernel_does_not_take():
    feats, idx, w = random_tile_stack(np.random.default_rng(2), t=2, d_i=8,
                                      d_o=4, k=8, c=4, n=8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sspnna_tiles(feats.double(), idx, w.double())
    with pytest.raises(TypeError, match="one dtype"):
        sspnna_tiles(feats, idx, w.bfloat16())
    with pytest.raises(TypeError, match="int32"):
        sspnna_tiles(feats, idx.long(), w)
    with pytest.raises(ValueError, match="disagree"):
        sspnna_tiles(feats, idx, w[:, :2])
    with pytest.raises(ValueError, match="disagree"):
        sspnna_tiles(feats[:1], idx, w)
    with pytest.raises(ValueError, match=r"\(T, dI, C\)"):
        sspnna_tiles(feats[0], idx, w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sspnna_tiles(feats.to("meta"), idx.to("meta"), w.to("meta"))
    with pytest.raises(RuntimeError, match="forward-only"):
        sspnna_tiles(feats, idx, w.requires_grad_())
