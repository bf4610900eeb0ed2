"""Port parity: the host planners and plain tensor ops of ``repro_torch``
against the JAX package, module by module, on one small scene."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import host_meta as jhm
from repro.core import soar as jsoar
from repro.core import spade as jspade
from repro.core import tiles as jtiles
from repro.core.coir import COIR as JCOIR
from repro.core.hashgrid import kernel_offsets as jkernel_offsets
from repro.core.sparse_conv import SparseConvParams as JParams
from repro.core.sparse_conv import masked_batchnorm_relu as jbn_relu
from repro.core.sparse_conv import reference_conv_cirf as jreference_conv
from repro.models.scn import miou as jmiou
from repro.sparse.tensor import linear_key as jlinear_key
from repro_torch.core import host_meta, soar, spade, tiles
from repro_torch.core.coir import COIR, kernel_offsets_np
from repro_torch.core.sparse_conv import (
    SparseConvParams,
    masked_batchnorm_relu,
    reference_conv_cirf,
)
from repro_torch.data.scenes import make_scene
from repro_torch.models.scn import miou
from repro_torch.sparse.tensor import linear_key

RES, CAP = 24, 2048


@pytest.fixture(scope="module")
def scene():
    coords, feats, labels, mask = make_scene(0, resolution=RES, capacity=CAP)
    offs = kernel_offsets_np(3)
    sub = host_meta.build_cirf_np(coords, mask, coords, mask, offs, RES)
    return coords, feats, labels, mask, sub


def _assert_tree_equal(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("size,centered", [(3, None), (2, False), (3, False)])
def test_kernel_offsets_equal(size, centered):
    np.testing.assert_array_equal(kernel_offsets_np(size, centered),
                                  jkernel_offsets(size, centered))


def test_linear_keys_equal(scene):
    coords, _, _, mask, _ = scene
    np.testing.assert_array_equal(host_meta.linear_key_np(coords, RES, mask),
                                  jhm.linear_key_np(coords, RES, mask))
    for m in (mask, None):
        got = linear_key(torch.from_numpy(coords), RES,
                         None if m is None else torch.from_numpy(m))
        want = jlinear_key(jnp.asarray(coords), RES,
                           None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_admac_tables_equal(scene):
    coords, _, _, mask, sub = scene
    offs2 = kernel_offsets_np(2, centered=False)
    _assert_tree_equal(sub, jhm.build_cirf_np(
        coords, mask, coords, mask, jkernel_offsets(3), RES))
    dn, dn_mask = host_meta.downsample_coords_np(coords, mask, RES, 2)
    _assert_tree_equal((dn, dn_mask), jhm.downsample_coords_np(coords, mask, RES, 2))
    _assert_tree_equal(
        host_meta.build_cirf_np(dn, dn_mask, coords, mask, offs2, RES, 2),
        jhm.build_cirf_np(dn, dn_mask, coords, mask, offs2, RES, 2))
    _assert_tree_equal(
        host_meta.build_corf_np(dn, dn_mask, coords, mask, offs2, RES, 2),
        jhm.build_corf_np(dn, dn_mask, coords, mask, offs2, RES, 2))
    _assert_tree_equal(
        host_meta.transposed_coir_np(dn, dn_mask, coords, mask, RES),
        jhm.transposed_coir_np(dn, dn_mask, coords, mask, RES))


def test_coir_attributes_equal(scene):
    _, _, _, _, sub = scene
    jc = JCOIR(*(jnp.asarray(x) for x in sub))
    for c in (COIR(*sub), COIR(*(torch.from_numpy(x) for x in sub))):
        np.testing.assert_array_equal(np.asarray(c.popcount()),
                                      np.asarray(jc.popcount()))
        assert c.n_pairs() == int(jc.n_pairs())
        assert c.arf() == pytest.approx(float(jc.arf()), rel=1e-6)


def test_orders_equal(scene):
    coords, _, _, mask, sub = scene
    for chunk in (64, 512):
        got = soar.soar_order(sub.indices, mask, chunk)
        want = jsoar.soar_order(sub.indices, mask, chunk)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_array_equal(got.chunk_starts, want.chunk_starts)
    np.testing.assert_array_equal(soar.raster_order(coords, mask),
                                  jsoar.raster_order(coords, mask))


@pytest.mark.parametrize("budget", [16 * 1024, 64 * 1024, 1024])
def test_spade_choice_equal(scene, budget):
    _, _, _, mask, sub = scene
    order = soar.soar_order(sub.indices, mask, 512).order
    attrs = spade.extract_attributes(sub.indices, mask, order)
    jattrs = jspade.extract_attributes(sub.indices, mask, order)
    for f in dataclasses.fields(attrs):
        np.testing.assert_array_equal(getattr(attrs, f.name),
                                      getattr(jattrs, f.name))
    n = int(mask.sum())
    for c in (4, 16, 48):
        got = spade.explore(spade.LayerSpec("l", n, n, 27, c, c), {
            "CIRF": attrs, "CORF": attrs}, budget)
        want = jspade.explore(jspade.LayerSpec("l", n, n, 27, c, c), {
            "CIRF": jattrs, "CORF": jattrs}, budget)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("d_o,d_i,budgeted", [
    (32, 96, False), (128, 400, False), (8, 12, False), (32, 96, True)])
def test_tile_plans_equal(scene, d_o, d_i, budgeted):
    _, _, _, mask, sub = scene
    order = soar.soar_order(sub.indices, mask, 512).order
    n_tiles = (tiles.max_tiles(int(mask.sum()), d_o, d_i, 27)
               if budgeted else None)
    assert n_tiles == (jtiles.max_tiles(int(mask.sum()), d_o, d_i, 27)
                       if budgeted else None)
    got = tiles.build_tile_plan(sub.indices, order, d_o, d_i, n_tiles=n_tiles)
    want = jtiles.build_tile_plan(sub.indices, order, d_o, d_i, n_tiles=n_tiles)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name))
    _assert_tree_equal(tiles.dma_tile_tables(got, CAP),
                       jtiles.dma_tile_tables(want, CAP))


def test_reference_conv_and_bn_match_jax(scene):
    coords, _, _, mask, sub = scene
    rng = np.random.default_rng(1)
    x = rng.normal(size=(CAP, 16)).astype(np.float32)
    w = (rng.normal(size=(27, 16, 48)) * 0.1).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    want = jreference_conv(jnp.asarray(x), JCOIR(*(jnp.asarray(a) for a in sub)),
                           JParams(jnp.asarray(w), jnp.asarray(b)))
    coir = COIR(torch.from_numpy(sub.indices), None, torch.from_numpy(mask))
    got = reference_conv_cirf(torch.from_numpy(x), coir, SparseConvParams(
        torch.from_numpy(w), torch.from_numpy(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    scale = rng.normal(size=(48,)).astype(np.float32)
    offset = rng.normal(size=(48,)).astype(np.float32)
    want_bn = jbn_relu(want, jnp.asarray(mask), jnp.asarray(scale),
                       jnp.asarray(offset))
    got_bn = masked_batchnorm_relu(got, torch.from_numpy(mask),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(offset))
    np.testing.assert_allclose(got_bn.numpy(), np.asarray(want_bn),
                               rtol=1e-4, atol=1e-4)


def test_miou_equal(scene):
    _, _, labels, mask, _ = scene
    pred = np.random.default_rng(2).integers(0, 5, labels.shape)
    assert miou(pred, labels, mask, 5) == jmiou(pred, labels, mask, 5)


@pytest.mark.parametrize("d_o,d_i", [(8, 16), (32, 20), (4, 8)])
def test_plane_split_tile_plans_equal(scene, d_o, d_i):
    """Unbudgeted plans with delta_i < 27: rows whose partners overflow the
    working set are split across plane groups, identically in both."""
    _, _, _, mask, sub = scene
    order = soar.soar_order(sub.indices, mask, 512).order
    got = tiles.build_tile_plan(sub.indices, order, d_o, d_i)
    want = jtiles.build_tile_plan(sub.indices, order, d_o, d_i)
    assert got.n_row_splits > 0
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name))
    _assert_tree_equal(tiles.dma_tile_tables(got, CAP),
                       jtiles.dma_tile_tables(want, CAP))


@pytest.mark.parametrize("d_o,d_i,budgeted", [
    (32, 96, False), (8, 16, False), (32, 96, True)])
def test_dma_accounting_and_modeled_bytes_equal(scene, d_o, d_i, budgeted):
    _, _, _, mask, sub = scene
    order = soar.soar_order(sub.indices, mask, 512).order
    n_tiles = (tiles.max_tiles(int(mask.sum()), d_o, d_i, 27)
               if budgeted else None)
    got = tiles.build_tile_plan(sub.indices, order, d_o, d_i, n_tiles=n_tiles)
    want = jtiles.build_tile_plan(sub.indices, order, d_o, d_i,
                                  n_tiles=n_tiles)
    assert tiles.plan_dma_tables(got) == jtiles.plan_dma_tables(want)
    for c, n, itemsize in ((4, 16, 4), (32, 32, 4), (16, 16, 2)):
        assert (tiles.modeled_hbm_bytes(got, c, n, itemsize)
                == jtiles.modeled_hbm_bytes(want, c, n, itemsize))
