"""Port parity: the standalone sparse-conv layer library of ``repro_torch``
(dense <-> sparse tensors, the device-side AdMAC search and COIR builders,
the layer helpers, ``conv_plan_for_layer`` and the engine's entry points)
against the JAX package on the CPU, on a real sphere-shell scene."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_shell_scene
from repro import engine as jengine
from repro.core import coir as jcoir
from repro.core import hashgrid as jhashgrid
from repro.core import sparse_conv as jsc
from repro.sparse import tensor as jtensor
from repro_torch import engine
from repro_torch.core import coir, hashgrid, host_meta, soar, spade
from repro_torch.core import sparse_conv as sc
from repro_torch.core.sparse_conv import SparseConvParams
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles
from repro_torch.sparse import tensor

RES = 18
# whole convs: f32 sums of up to 27*C products per output, in another order
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def scene():
    """A shell scene (770 active voxels, 4 channels) on both sides, padded
    to a capacity of 1024."""
    dense = make_shell_scene(np.random.default_rng(0), RES, 4)
    ours = tensor.from_dense(dense, 1024, device="cpu")
    theirs = jtensor.from_dense(dense, 1024)
    return dense, ours, theirs


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _coir_eq(got: coir.COIR, want):
    """Integer COIR tables exactly equal; the port's int32 bitmask holds
    the bits of JAX's uint32 one."""
    _eq(got.indices, want.indices)
    assert got.bitmask.dtype == torch.int32
    _eq(got.bitmask.numpy().astype(np.uint32), want.bitmask)
    _eq(got.mask, want.mask)


def _params(rng, k, c, n):
    """The same seeded weights for both packages (JAX, port)."""
    w = (rng.normal(size=(k, c, n)) / np.sqrt(k * c)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return (jsc.SparseConvParams(jnp.asarray(w), jnp.asarray(b)),
            SparseConvParams(torch.from_numpy(w), torch.from_numpy(b)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or CONV_TOL))


def test_from_dense_to_dense_and_compact_equal(scene):
    dense, ours, theirs = scene
    for a, b in zip(ours, theirs, strict=True):
        _eq(a, b)
    assert ours.n_active() == int(theirs.n_active()) == 770
    np.testing.assert_array_equal(tensor.to_dense(ours, RES), dense)
    np.testing.assert_array_equal(tensor.to_dense(ours, RES),
                                  jtensor.to_dense(theirs, RES))
    got, got_idx = tensor.compact_to_capacity(ours, 800)
    want, want_idx = jtensor.compact_to_capacity(theirs, 800)
    for a, b in zip(got, want, strict=True):
        _eq(a, b)
    _eq(got_idx, want_idx)
    with pytest.raises(ValueError, match="capacity"):
        tensor.compact_to_capacity(ours, 100)
    with pytest.raises(ValueError, match="capacity"):
        tensor.from_dense(dense, 100, device="cpu")


def test_sorted_grid_and_neighbor_table_equal(scene):
    _, ours, theirs = scene
    offs = hashgrid.kernel_offsets(3)
    grid = hashgrid.SortedGrid(ours.coords, ours.mask, RES)
    jgrid = jhashgrid.SortedGrid(theirs.coords, theirs.mask, RES)
    _eq(grid.sorted_keys, jgrid.sorted_keys)
    _eq(grid.sorted_idx, jgrid.sorted_idx)
    # probes in and out of bounds, some masked off
    q = np.random.default_rng(3).integers(-2, RES + 2, (500, 3)).astype(np.int32)
    qv = np.random.default_rng(4).random(500) < 0.8
    _eq(grid.lookup(torch.from_numpy(q), torch.from_numpy(qv)),
        jgrid.lookup(jnp.asarray(q), jnp.asarray(qv)))
    nbr = hashgrid.build_neighbor_table(ours.coords, ours.mask, offs, RES)
    _eq(nbr, jhashgrid.build_neighbor_table(theirs.coords, theirs.mask,
                                            jnp.asarray(offs), RES))
    _eq(nbr, host_meta.query_neighbors_np(ours.coords.numpy(),
                                          ours.mask.numpy(),
                                          ours.coords.numpy(),
                                          ours.mask.numpy(), offs, RES))


@pytest.mark.parametrize("capacity_out", [None, 64])
def test_downsample_coords_equal(scene, capacity_out):
    """The strided conv's output set, padded with PAD_COORD rows; a
    capacity below the unique count drops the rest, as in JAX."""
    _, ours, theirs = scene
    got = hashgrid.downsample_coords(ours.coords, ours.mask, RES, 2,
                                     capacity_out)
    want = jhashgrid.downsample_coords(theirs.coords, theirs.mask, RES, 2,
                                       capacity_out)
    host = host_meta.downsample_coords_np(ours.coords.numpy(),
                                          ours.mask.numpy(), RES, 2,
                                          capacity_out)
    for a, b, h in zip(got, want, host, strict=True):
        _eq(a, b)
        _eq(a, h)
    assert hashgrid.upsample_coords(ours.coords, ours.mask)[0] is ours.coords


def test_coir_builders_equal_jax_and_host_twins(scene):
    _, ours, theirs = scene
    offs3 = hashgrid.kernel_offsets(3)
    offs2 = hashgrid.kernel_offsets(2, centered=False)
    sub = coir.build_cirf(ours.coords, ours.mask, ours.coords, ours.mask,
                          offs3, RES)
    _coir_eq(sub, jcoir.build_cirf(theirs.coords, theirs.mask, theirs.coords,
                                   theirs.mask, jnp.asarray(offs3), RES))
    _coir_eq(sub, host_meta.build_cirf_np(
        ours.coords.numpy(), ours.mask.numpy(), ours.coords.numpy(),
        ours.mask.numpy(), offs3, RES))
    dn, dn_mask = hashgrid.downsample_coords(ours.coords, ours.mask, RES)
    jdn, jdn_mask = jhashgrid.downsample_coords(theirs.coords, theirs.mask, RES)
    for build, jbuild, hbuild in (
            (coir.build_cirf, jcoir.build_cirf, host_meta.build_cirf_np),
            (coir.build_corf, jcoir.build_corf, host_meta.build_corf_np)):
        got = build(dn, dn_mask, ours.coords, ours.mask, offs2, RES, 2)
        _coir_eq(got, jbuild(jdn, jdn_mask, theirs.coords, theirs.mask,
                             jnp.asarray(offs2), RES, 2))
        _coir_eq(got, hbuild(dn.numpy(), dn_mask.numpy(), ours.coords.numpy(),
                             ours.mask.numpy(), offs2, RES, 2))
    _coir_eq(coir.transpose_flavor(sub, 1024),
             jcoir.transpose_flavor(jcoir.COIR(*map(jnp.asarray, (
                 sub.indices.numpy(), sub.bitmask.numpy().astype(np.uint32),
                 sub.mask.numpy()))), 1024))
    jsub = jcoir.build_cirf(theirs.coords, theirs.mask, theirs.coords,
                            theirs.mask, jnp.asarray(offs3), RES)
    assert coir.coir_size_words(sub) == int(jcoir.coir_size_words(jsub))
    assert coir.rulebook_size_words(sub) == int(jcoir.rulebook_size_words(jsub))


def test_submanifold_conv_matches_jax_and_dense_oracle(scene):
    dense, ours, theirs = scene
    jp, p = _params(np.random.default_rng(5), 27, 4, 8)
    sub = sc.submanifold_coir(ours, RES, 3)
    jsub = jsc.submanifold_coir(theirs, RES, 3)
    _coir_eq(sub, jsub)
    got = sc.submanifold_conv(ours, sub, p)
    want = jsc.submanifold_conv(theirs, jsub, jp)
    _close(got.feats, want.feats)
    _eq(got.coords, want.coords)
    oracle = sc.dense_submanifold_reference(dense, p.weight.numpy(),
                                            p.bias.numpy())
    np.testing.assert_array_equal(oracle, jsc.dense_submanifold_reference(
        dense, np.asarray(jp.weight), np.asarray(jp.bias)))
    np.testing.assert_allclose(tensor.to_dense(got, RES), oracle, **CONV_TOL)
    scale = np.linspace(0.5, 1.5, 8).astype(np.float32)
    offset = np.linspace(-0.2, 0.2, 8).astype(np.float32)
    _close(sc.batchnorm_relu(got, torch.from_numpy(scale),
                             torch.from_numpy(offset)).feats,
           jsc.batchnorm_relu(want, jnp.asarray(scale),
                              jnp.asarray(offset)).feats)


def test_strided_and_transposed_conv_match_jax(scene):
    _, ours, theirs = scene
    rng = np.random.default_rng(6)
    jdown, down = _params(rng, 8, 4, 8)
    jup, up = _params(rng, 8, 8, 4)
    coarse, res, dcoir = sc.strided_conv(ours, RES, down)
    jcoarse, jres, jdcoir = jsc.strided_conv(theirs, RES, jdown)
    assert res == jres == RES // 2
    _coir_eq(dcoir, jdcoir)
    _eq(coarse.coords, jcoarse.coords)
    _eq(coarse.mask, jcoarse.mask)
    _close(coarse.feats, jcoarse.feats)
    tcoir = sc.transposed_coir(coarse, ours.coords, ours.mask, RES)
    jtcoir = jsc.transposed_coir(jcoarse, theirs.coords, theirs.mask, RES)
    _coir_eq(tcoir, jtcoir)
    fine = sc.transposed_conv(coarse, tcoir, ours.coords, ours.mask, up)
    jfine = jsc.transposed_conv(jcoarse, jtcoir, theirs.coords, theirs.mask,
                                jup)
    _close(fine.feats, jfine.feats)
    # the in-major (CORF) evaluation of the strided conv
    corf = coir.build_corf(coarse.coords, coarse.mask, ours.coords, ours.mask,
                           hashgrid.kernel_offsets(2, centered=False), RES, 2)
    jcorf = jcoir.build_corf(jcoarse.coords, jcoarse.mask, theirs.coords,
                             theirs.mask, jnp.asarray(
                                 jhashgrid.kernel_offsets(2, centered=False)),
                             RES, 2)
    got = sc.sparse_conv_corf(ours.feats, corf, down, coarse.capacity)
    want = jsc.sparse_conv_corf(theirs.feats, jcorf, jdown, jcoarse.capacity)
    _close(got, want)
    _close(got, coarse.feats)  # CORF == CIRF evaluation of the same conv


def test_init_sparse_conv_and_deprecated_cirf(scene):
    _, ours, _ = scene
    p = sc.init_sparse_conv(torch.Generator().manual_seed(0), 27, 4, 8,
                            device="cpu")
    again = sc.init_sparse_conv(torch.Generator().manual_seed(0), 27, 4, 8,
                                device="cpu")
    assert p.weight.shape == (27, 4, 8) and not p.bias.any()
    torch.testing.assert_close(p.weight, again.weight, rtol=0, atol=0)
    assert 0.5 < float(p.weight.std() * np.sqrt(27 * 4)) < 1.5
    sub = sc.submanifold_coir(ours, RES)
    with pytest.warns(DeprecationWarning, match="sparse_conv_cirf"):
        got = sc.sparse_conv_cirf(ours.feats, sub, p)
    torch.testing.assert_close(got, sc.reference_conv_cirf(ours.feats, sub, p),
                               rtol=0, atol=0)


def _layer_plan(t, coir_, delta_o=64, delta_i=192):
    order = soar.soar_order(hashgrid.build_neighbor_table(
        t.coords, t.mask, hashgrid.kernel_offsets(3), RES).numpy(),
        t.mask.numpy(), 64).order
    return order, delta_o, delta_i


def test_conv_plan_for_layer_and_sparse_conv_match_jax(scene):
    """The quickstart's standalone path (``test_sspnna_full_conv_path``):
    SOAR order, ``conv_plan_for_layer``, then ``sparse_conv`` on the
    ``sspnna`` backend (fused, and with ``use_kernel=False`` the oracle
    branch) and on ``reference``, against the same calls in JAX."""
    _, ours, theirs = scene
    sub = sc.submanifold_coir(ours, RES)
    jsub = jsc.submanifold_coir(theirs, RES)
    order, d_o, d_i = _layer_plan(ours, sub)
    cp = engine.conv_plan_for_layer(sub, order, d_o, d_i, device="cpu")
    jcp = jengine.conv_plan_for_layer(jsub, order, d_o, d_i)
    for a, b in zip(cp.tiles, jcp.tiles, strict=True):
        _eq(a, b)
    _coir_eq(cp.coir, jsub)
    want_dispatch = jcp.dispatch
    assert (cp.dispatch.backend, cp.dispatch.delta_o, cp.dispatch.delta_i,
            cp.dispatch.n_tiles) == (want_dispatch.backend,
                                     want_dispatch.delta_o,
                                     want_dispatch.delta_i,
                                     want_dispatch.n_tiles)
    jp, p = _params(np.random.default_rng(7), 27, 4, 16)
    launches = sspnna_fused.launches, sspnna_tiles.launches
    for backend, use_kernel in (("sspnna", True), ("sspnna", False),
                                ("reference", True)):
        got = engine.sparse_conv(ours.feats, p, cp, backend=backend,
                                 use_kernel=use_kernel)
        want = jengine.sparse_conv(theirs.feats, jp, jcp, backend=backend,
                                   use_kernel=use_kernel, interpret=True)
        _close(got, want)
    assert (sspnna_fused.launches, sspnna_tiles.launches) == launches
    ref = engine.sparse_conv(ours.feats, p, engine.reference_plan(sub))
    _close(engine.sparse_conv(ours.feats, p, cp), ref)


def test_conv_plan_for_layer_rejects_plane_splits():
    cirf = np.array([[1, 2, 3, 4], [2, 3, 4, 5]], np.int32)
    c = coir.COIR(cirf, np.zeros((2,), np.uint32), np.ones((8,), bool))
    with pytest.raises(ValueError, match="plane-split"):
        engine.conv_plan_for_layer(c, np.arange(2), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="plane-split"):
        jengine.conv_plan_for_layer(jcoir.COIR(*map(jnp.asarray, c)),
                                    np.arange(2), 2, 2)


def test_engine_resolution_helpers(scene):
    _, ours, _ = scene
    sub = sc.submanifold_coir(ours, RES)
    plan = engine.reference_plan(sub)
    assert plan.tiles is None and plan.dispatch.backend == engine.REFERENCE
    assert engine.resolve_backend(plan) == engine.REFERENCE
    assert engine.resolve_backend(plan, engine.SSPNNA) == engine.REFERENCE
    order, d_o, d_i = _layer_plan(ours, sub)
    cp = engine.conv_plan_for_layer(sub, order, d_o, d_i, device="cpu")
    assert engine.resolve_backend(cp) == engine.SSPNNA
    assert engine.available_backends() == ("auto", "reference", "sharded",
                                           "sspnna")
    # the JAX package registers the same three (sharded scenes came with
    # slice 9)
    assert engine.available_backends() == jengine.available_backends()


class _Doubled:
    """A backend that runs ``reference`` and doubles its output."""

    def run(self, x, params, plan, *, use_kernel=True):
        return 2 * engine.sparse_conv(x, params, engine.reference_plan(
            plan.coir))


def test_backends_alias_is_live_as_in_jax():
    """``engine.BACKENDS`` and ``engine.api.BACKENDS`` are computed on
    access from the default registry (``AUTO`` then its names), so a
    backend registered after import shows, and goes when unregistered,
    as ``tests/test_engine.py`` checks for the JAX package."""
    from repro_torch.engine import api

    assert engine.BACKENDS == api.BACKENDS == engine.available_backends()
    assert engine.BACKENDS == jengine.BACKENDS
    assert "BACKENDS" in engine.__all__
    engine.register_backend("doubled", _Doubled())
    try:
        assert "doubled" in engine.BACKENDS and "doubled" in api.BACKENDS
        assert engine.BACKENDS[0] == engine.AUTO
    finally:
        engine.default_registry().unregister("doubled")
    assert "doubled" not in engine.BACKENDS
    with pytest.raises(AttributeError):
        engine.NOT_A_NAME  # noqa: B018
    with pytest.raises(AttributeError):
        api.NOT_A_NAME  # noqa: B018


def test_quickstart_spade_path_matches_jax(scene):
    """The quickstart's SPADE step on the port's device-built COIR: the
    chosen tile height and the ``delta_i`` derived from it agree with JAX's
    on the same tables."""
    _, ours, theirs = scene
    from repro.core import soar as jsoar
    from repro.core import spade as jspade

    sub = sc.submanifold_coir(ours, RES)
    nbr = hashgrid.build_neighbor_table(ours.coords, ours.mask,
                                        hashgrid.kernel_offsets(3), RES).numpy()
    mask = ours.mask.numpy()
    order = soar.soar_order(nbr, mask, 64)
    np.testing.assert_array_equal(order.order,
                                  jsoar.soar_order(nbr, mask, 64).order)
    n = ours.n_active()
    attrs = spade.extract_attributes(sub.indices.numpy(), mask, order.order)
    jattrs = jspade.extract_attributes(sub.indices.numpy(), mask, order.order)
    layer = ("demo", n, n, 27, 4, 32, 2)
    got = spade.explore(spade.LayerSpec(*layer),
                        {"CIRF": attrs, "CORF": attrs}, 16 * 1024)
    want = jspade.explore(jspade.LayerSpec(*layer),
                          {"CIRF": jattrs, "CORF": jattrs}, 16 * 1024)
    assert (got.walk, got.flavor, got.delta_major) == (
        want.walk, want.flavor, want.delta_major)


def test_layer_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    dense = make_shell_scene(np.random.default_rng(0), 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensor.from_dense(dense)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.init_sparse_conv(torch.Generator(), 27, 2, 4)
    t = tensor.from_dense(dense, device="cpu")
    sub = sc.submanifold_coir(t, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.conv_plan_for_layer(sub, np.flatnonzero(t.mask.numpy()), 8, 64)


def test_jax_params_carry_over(scene):
    """``init_sparse_conv``'s JAX weights carried across give the port the
    same conv as JAX (the way ``params_from_jax`` carries a U-Net)."""
    _, ours, theirs = scene
    jp = jsc.init_sparse_conv(jax.random.PRNGKey(0), 27, 4, 8)
    p = SparseConvParams(*(torch.from_numpy(np.array(x)) for x in jp))
    sub = sc.submanifold_coir(ours, RES)
    jsub = jsc.submanifold_coir(theirs, RES)
    _close(sc.reference_conv_cirf(ours.feats, sub, p),
           jsc.reference_conv_cirf(theirs.feats, jsub, jp))
