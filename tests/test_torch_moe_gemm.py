"""Port parity: the grouped expert GEMM's wrapper (on the CPU: its plain
version) and oracle in ``repro_torch`` against the JAX package's Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it) and oracle.

The JAX kernel stores in xin's dtype; the port also stores f32 when asked,
which the MoE layer does where the JAX package keeps an f32 einsum result
(``repro.models.moe``): such a case is held against that einsum.
Tolerances (``kernels/moe_gemm/ref.moe_gemm_tol``): 1e-5 where inputs and
output are f32 or the inputs bf16 and the output f32 (bf16 products are
exact in f32; the sums run in another order); 2e-2 where the output is
rounded to bf16, as in ``tests/test_kernels.py``.
"""
import ctypes
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.moe_gemm import grouped_gemm as jax_grouped_gemm
from repro.kernels.moe_gemm.ref import grouped_gemm_ref as jax_grouped_gemm_ref
from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm import moe_gemm as moe_gemm_module
from repro_torch.kernels.moe_gemm.moe_gemm import ARGTYPES, KERNEL, grouped_gemm
from repro_torch.kernels.moe_gemm.ops import grouped_gemm_ref
from repro_torch.kernels.moe_gemm.ref import (
    MOE_GEMM_CASES,
    moe_gemm_tol,
    random_moe_inputs,
)

# (e, c, d, f, block_f of the JAX kernel, valid share): the JAX test's three
# shapes, C, d and f that are not multiples of the CUDA kernel's tiles, and
# an expert with no valid row (a negative share empties expert 0)
SHAPES = [
    (4, 16, 32, 64, None, 0.7),
    (8, 8, 64, 128, 32, 0.7),
    (2, 32, 16, 48, 16, 0.7),
    (3, 77, 45, 101, None, 0.6),
    (5, 20, 24, 40, None, -0.5),
]
DTYPES = [torch.float32, torch.bfloat16]


def _jnp(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "e{}c{}d{}f{}bf{}v{}".format(*s))
def test_grouped_gemm_matches_jax(shape, dtype, out_dtype):
    e, c, d, f, block_f, share = shape
    xin, w, valid = random_moe_inputs(np.random.default_rng(c + d + f), e=e,
                                      c=c, d=d, f=f, valid_share=share,
                                      dtype=dtype)
    launches = grouped_gemm.launches
    got = grouped_gemm(xin, w, valid, out_dtype=out_dtype)
    assert grouped_gemm.launches == launches   # CPU: the plain version
    assert got.dtype == out_dtype and got.shape == (e, c, f)
    assert not got[~valid].any()               # invalid rows are exact zeros
    ref = grouped_gemm_ref(xin, w, valid, out_dtype)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    jx, jw, jv = _jnp(xin), _jnp(w), jnp.asarray(valid.numpy())
    if out_dtype == dtype:   # the TPU kernel's own contract
        want = [jax_grouped_gemm(jx, jw, jv, block_f=block_f),
                jax_grouped_gemm_ref(jx, jw, jv)]
    else:                    # the f32 einsum of repro.models.moe
        want = [jnp.einsum("ecd,edf->ecf", jnp.where(jv[..., None], jx, 0),
                           jw, preferred_element_type=jnp.float32)]
    tol = moe_gemm_tol(dtype, out_dtype)
    for x in want:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(x.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "case", MOE_GEMM_CASES,
    ids=lambda s: "e{}c{}d{}f{}v{}-{}-{}".format(
        *s[:5], *(str(t).removeprefix("torch.") for t in s[5:])))
def test_oracle_matches_jax_oracle_on_card_cases(case):
    """The card's cases on the CPU: the port's oracle against the JAX
    package's f32 einsum of the same masked inputs."""
    e, c, d, f, share, dtype, out_dtype = case
    if e * c * d * f > 2 ** 26:
        e = 2   # the decode-width cases: two experts keep the CPU run short
    xin, w, valid = random_moe_inputs(np.random.default_rng(e + c), e=e, c=c,
                                      d=d, f=f, valid_share=share, dtype=dtype)
    got = grouped_gemm_ref(xin, w, valid, out_dtype)
    want = jnp.einsum("ecd,edf->ecf",
                      jnp.where(jnp.asarray(valid.numpy())[..., None],
                                _jnp(xin), 0), _jnp(w),
                      preferred_element_type=jnp.float32)
    tol = moe_gemm_tol(dtype, out_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xin, w, valid = random_moe_inputs(np.random.default_rng(0), e=2, c=8,
                                      d=16, f=24, valid_share=0.5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grouped_gemm(xin.half(), w.half(), valid)
    with pytest.raises(TypeError, match="one dtype"):
        grouped_gemm(xin, w.bfloat16(), valid)
    with pytest.raises(TypeError, match="valid must be bool"):
        grouped_gemm(xin, w, valid.to(torch.uint8))
    with pytest.raises(TypeError, match="out_dtype"):
        grouped_gemm(xin, w, valid, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="do not match"):
        grouped_gemm(xin, w[:, :8], valid)
    with pytest.raises(ValueError, match="do not match"):
        grouped_gemm(xin, w, valid[:, :4])
    with pytest.raises(ValueError, match="expected xin"):
        grouped_gemm(xin[0], w, valid)
    with pytest.raises(RuntimeError, match="forward-only"):
        grouped_gemm(xin.requires_grad_(), w, valid)


def test_wrapper_runs_the_plain_version_only_on_the_cpu(monkeypatch):
    """Tensors off the CPU never reach the plain version, and nothing is
    counted: meta tensors (no data) take the fake launch the dry run
    uses, an empty (E, C, f) output on meta."""
    xin, w, valid = (x.to("meta") for x in random_moe_inputs(
        np.random.default_rng(0), e=2, c=8, d=16, f=24, valid_share=0.5))
    launches = grouped_gemm.launches
    monkeypatch.setattr(moe_gemm_module, "grouped_gemm_ref", None)
    out = grouped_gemm(xin, w, valid)
    assert out.device.type == "meta" and out.shape == (2, 8, 24)
    assert grouped_gemm.launches == launches


def test_argtypes_match_the_c_signature():
    """ctypes passes what ARGTYPES says; the C function must take exactly
    that (a missing or extra int shifts every argument after it)."""
    src = (build.CSRC / f"{KERNEL}.cu").read_text()
    params = re.search(r"int moe_gemm\(([^)]*)\)", src).group(1).split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    want = [kinds[re.sub(r"\s+", "", p.rsplit(None, 1)[0]).removeprefix(
        "const")] for p in params]
    assert want == ARGTYPES


# the entry functions ptxas -v printed for csrc/moe_gemm.cu on the card (an
# H100 build, names as mangled in its anonymous namespace)
P = "_ZN44_GLOBAL__N__34a4ae3e_11_moe_gemm_cu_moe_gemm"
MOE_GEMM_ENTRIES = [
    P + "6decode11slab_kernelI13__nv_bfloat16Lb0ELi4EEEvPKS2_S4_PKhPT_iii",
    P + "6decode11slab_kernelI13__nv_bfloat16Lb0ELi1EEEvPKS2_S4_PKhPT_iii",
    P + "6decode11slab_kernelI13__nv_bfloat16Lb1ELi4EEEvPKS2_S4_PKhPT_iii",
    P + "6decode11slab_kernelI13__nv_bfloat16Lb1ELi1EEEvPKS2_S4_PKhPT_iii",
    P + "6decode11slab_kernelIfLb0ELi4EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "6decode11slab_kernelIfLb0ELi1EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "6decode11slab_kernelIfLb1ELi4EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "6decode11slab_kernelIfLb1ELi1EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "7prefill11tile_kernelI13__nv_bfloat16Lb0EEEvPKS2_S4_PKhPT_iii",
    P + "7prefill11tile_kernelI13__nv_bfloat16Lb1EEEvPKS2_S4_PKhPT_iii",
    P + "7prefill11tile_kernelIfLb0EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "7prefill11tile_kernelIfLb1EEEvPK13__nv_bfloat16S4_PKhPT_iii",
    P + "19moe_gemm_f32_kernelI13__nv_bfloat16EEvPKfS3_PKhPT_iii",
    P + "19moe_gemm_f32_kernelIfEEvPKfS2_PKhPT_iii",
]


def test_chip_smoke_names_every_moe_gemm_instantiation():
    """chip_smoke.py fails unless ptxas reports MOE_GEMM_INSTANCES kernels
    of moe_gemm.cu, each under a readable name of its own."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    labels = {chip_smoke.moe_gemm_label(n) for n in MOE_GEMM_ENTRIES}
    assert len(labels) == len(MOE_GEMM_ENTRIES) == chip_smoke.MOE_GEMM_INSTANCES
    assert not any(label.startswith("_Z") for label in labels)
    assert "bf16 wgmma tile, f32 out, 16-byte copies" in labels
    assert "bf16 slab, bf16 out, 2-byte loads, 64 rows" in labels
