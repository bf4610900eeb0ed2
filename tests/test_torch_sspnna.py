"""Port parity: the fused SSpNNA conv of ``repro_torch`` against the JAX
package's Pallas kernel, run in interpret mode on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sspnna.ops import run_sspnna_conv as jax_run_sspnna_conv
from repro.kernels.sspnna.ref import sspnna_tile_ref as jax_tile_ref
from repro.kernels.sspnna.sspnna import sspnna_fused as jax_sspnna_fused
from repro_torch.core.tiles import TilePlan, dma_tile_tables
from repro_torch.kernels.sspnna.ops import run_sspnna_conv
from repro_torch.kernels.sspnna.ref import random_tile_tables, sspnna_tile_ref
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_fused_plain
from test_torch_cuda import K, SHAPES, TOL


@pytest.mark.parametrize("layout", ["raw", "dma"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "v{}c{}n{}t{}i{}o{}".format(*s))
def test_plain_fused_matches_jax_kernel(shape, layout):
    v, c, n, t, d_i, d_o = shape
    rng = np.random.default_rng(sum(shape))
    feats, weights, out_rows, in_rows, local_idx, counts = random_tile_tables(
        rng, v=v, c=c, n=n, t=t, d_i=d_i, d_o=d_o)
    assert (counts == 0).any() and (counts > 0).any()
    if layout == "dma":
        tp = TilePlan(out_rows, in_rows, local_idx, counts)
        dma = dma_tile_tables(tp, v)
        in_rows, out_rows = dma.in_rows, dma.out_rows
    want = np.asarray(jax_sspnna_fused(
        jnp.asarray(feats), jnp.asarray(weights), jnp.asarray(out_rows),
        jnp.asarray(in_rows), jnp.asarray(local_idx), jnp.asarray(counts),
        n_out=v, interpret=True))
    args = [torch.from_numpy(x) for x in
            (feats, weights, out_rows, in_rows, local_idx, counts)]
    launches = sspnna_fused.launches
    got = sspnna_fused(*args, n_out=v)
    assert sspnna_fused.launches == launches  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), sspnna_fused_plain(*args, n_out=v).numpy())


def test_tile_ref_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(4, 24, 16)).astype(np.float32)
    idx = rng.integers(-1, 24, (4, 8, K)).astype(np.int32)
    w = (rng.normal(size=(K, 16, 48)) * 0.1).astype(np.float32)
    want = np.asarray(jax_tile_ref(jnp.asarray(feats), jnp.asarray(idx),
                                   jnp.asarray(w)))
    got = sspnna_tile_ref(torch.from_numpy(feats), torch.from_numpy(idx),
                          torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_run_sspnna_conv_matches_jax():
    """The engine's entry to the kernel, on the fused path of both packages
    (JAX in interpret mode), with the tile plan's pair counts."""
    rng = np.random.default_rng(5)
    arrays = random_tile_tables(rng, v=80, c=8, n=16, t=4, d_i=16, d_o=8)
    *tables, counts = arrays
    want = np.asarray(jax_run_sspnna_conv(
        *map(jnp.asarray, tables), n_out=80, pair_counts=jnp.asarray(counts),
        interpret=True))
    got = run_sspnna_conv(*map(torch.from_numpy, tables), n_out=80,
                          pair_counts=torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(7)
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.from_numpy(x) for x in random_tile_tables(
            rng, v=40, c=4, n=16, t=2, d_i=8, d_o=4))
    with pytest.raises(TypeError, match="float32"):
        sspnna_fused(feats.double(), weights, out_rows, in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(TypeError, match="int32"):
        sspnna_fused(feats, weights, out_rows.long(), in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(ValueError, match="weights"):
        sspnna_fused(feats, weights[:, :2], out_rows, in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(ValueError, match="tile tables"):
        sspnna_fused(feats, weights, out_rows[:1], in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(RuntimeError, match="forward-only"):
        sspnna_fused(feats, weights.requires_grad_(), out_rows, in_rows,
                     local_idx, counts, n_out=40)
