"""Port parity: the flash attention kernel's plain version in ``repro_torch``
against the JAX package's Pallas kernel (interpret mode on the CPU), its
oracle and its GQA wrapper.

Layouts: the JAX kernel takes (BH, S, D); the port takes the model layout
(B, S, H, D), so a JAX case is the port's B=1 with H=BH. Tolerances: f32
1e-5 (sums in another order), bf16 2e-2 (the JAX kernel rounds p to bf16
before the PV product, the plain version keeps it in f32), as in
``tests/test_kernels.py``.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.flash import flash_attention as jax_flash_attention
from repro.kernels.flash.ops import flash_attention_bshd as jax_flash_bshd
from repro.kernels.flash.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash import flash
from repro_torch.kernels.flash.flash import (
    ARGTYPES,
    KERNEL,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.flash.ops import flash_attention_bshd
from repro_torch.kernels.flash.ref import FLASH_CASES, attention_ref, random_qkv
from test_torch_cuda import flash_case_id


def _tol(dt):
    return 2e-2 if dt == np.dtype(jnp.bfloat16) else 1e-5


# the sweep of tests/test_kernels.py, with S <= 256
SWEEP = [
    (4, 256, 256, 64, True, None, None, jnp.float32),
    (2, 128, 256, 64, True, None, None, jnp.float32),
    (2, 256, 256, 64, True, 64, None, jnp.float32),
    (2, 256, 256, 64, True, None, 50.0, jnp.float32),
    (2, 256, 256, 128, False, None, None, jnp.float32),
    (2, 256, 256, 64, True, None, None, jnp.bfloat16),
    (1, 64, 256, 32, True, 128, 30.0, jnp.float32),
]


def _to_torch(x):
    """A JAX array as a CPU tensor of the same dtype (bf16 widened exactly
    and narrowed back)."""
    a = np.array(x.astype(jnp.float32))
    return torch.from_numpy(a).to(getattr(torch, str(x.dtype)))


def _bhsd_to_bshd(x):
    return x.transpose(1, 0, 2)[None]   # (BH, S, D) -> (1, S, BH, D)


@pytest.mark.parametrize("bh,sq,skv,d,causal,window,cap,dt", SWEEP)
def test_plain_matches_jax_kernel_and_oracle(bh, sq, skv, d, causal, window,
                                             cap, dt):
    rng = np.random.default_rng(bh * sq + skv + d)
    q = jnp.asarray(rng.normal(size=(bh, sq, d)), dt)
    k = jnp.asarray(rng.normal(size=(bh, skv, d)), dt)
    v = jnp.asarray(rng.normal(size=(bh, skv, d)), dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    want_kernel = jax_flash_attention(q, k, v, block_q=64, block_kv=64,
                                      interpret=True, **kw)
    want_ref = jax_attention_ref(q[None], k[None], v[None], **kw)[0]
    launches = flash_attention.launches
    got = flash_attention(*(_to_torch(_bhsd_to_bshd(x)) for x in (q, k, v)),
                          **kw)
    assert flash_attention.launches == launches  # CPU tensors: plain version
    assert got.dtype == _to_torch(q).dtype
    got = got.float().numpy()[0].transpose(1, 0, 2)
    tol = _tol(np.dtype(dt))
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 4)])
def test_gqa_fold_matches_jax_wrapper(hq, hkv):
    """The kernel indexes kv head h // G where the JAX wrapper repeats k
    and v group-wise: the same function."""
    b, s, d = 2, 192, 32
    q, k, v = random_qkv(np.random.default_rng(hq + hkv), b=b, sq=s, skv=s,
                         hq=hq, hkv=hkv, d=d)
    want = jax_flash_bshd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                          causal=True, window=48, softcap=50.0, block_q=64,
                          block_kv=64, interpret=True)
    got = flash_attention_bshd(q, k, v, causal=True, window=48, softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                                (True, 40, 30.0),
                                                (False, None, 50.0)])
def test_attention_ref_matches_jax(causal, window, cap):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(2, 3, s, 32)).astype(np.float32)
               for s in (96, 128, 128))
    kw = dict(causal=causal, window=window, softcap=cap)
    want = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=flash_case_id)
def test_plain_matches_oracle_on_card_cases(case):
    """The card tests' cases on the CPU: the plain version against the
    oracle with k and v repeated per group; rows that see no key give 0 in
    the kernel's semantics (the oracle's softmax would average them)."""
    b, sq, skv, hq, hkv, d, causal, window, cap, dt = case
    q, k, v = random_qkv(np.random.default_rng(sq + skv + d), b=b, sq=sq,
                         skv=skv, hq=hq, hkv=hkv, d=d, dtype=dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = flash_attention_plain(q, k, v, **kw).float()
    g = hq // hkv
    ke, ve = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    want = attention_ref(q.transpose(1, 2), ke, ve, **kw).transpose(1, 2)
    # rows at negative positions see no key under a causal mask; without
    # one they see every key
    blind = max(0, sq - skv) if causal else 0
    assert not got[:, :blind].any()
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got[:, blind:].numpy(),
                               want[:, blind:].float().numpy(), rtol=tol,
                               atol=tol)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = random_qkv(np.random.default_rng(0), b=1, sq=8, skv=8, hq=4,
                         hkv=2, d=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.bfloat16(), v)
    # any head dim on the CPU (the plain version), as the JAX attention
    launches = flash_attention.launches
    q48, k48, v48 = (x[..., :48] for x in (q, k, v))
    assert torch.equal(flash_attention(q48, k48, v48),
                       flash_attention_plain(q48, k48, v48))
    assert flash_attention.launches == launches
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, k, v, softcap=-1.0)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("window", [None, 40], ids=["causal", "window"])
def test_head_dim_120_matches_jax_chunked_attention(window):
    """H2O-Danube-3's head dim: the wrapper's plain path and the model's
    ``chunked_attention`` against the JAX package's ``chunked_attention``
    (GQA group 4), f32 within 1e-5."""
    from repro.models.attention import chunked_attention as jax_chunked
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(120)
    q = rng.normal(size=(2, 96, 8, 120)).astype(np.float32)
    k, v = (rng.normal(size=(2, 96, 2, 120)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=window, q_chunk=32, kv_chunk=32))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for got in (flash_attention_plain(qt, kt, vt, window=window),
                chunked_attention(qt, kt, vt, window=window)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_runs_the_plain_version_only_on_the_cpu(monkeypatch):
    """Tensors off the CPU never reach the plain version, and nothing is
    counted: meta tensors (no data) take the fake launch the dry run
    uses, an empty output of q's shape on meta."""
    q, k, v = (x.to("meta") for x in random_qkv(
        np.random.default_rng(0), b=1, sq=8, skv=8, hq=2, hkv=1, d=32))
    launches = flash_attention.launches
    monkeypatch.setattr(flash, "flash_attention_plain", None)
    out = flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape
    assert flash_attention.launches == launches


def test_argtypes_match_the_c_signature():
    """ctypes passes what ARGTYPES says; the C function must take exactly
    that (a missing or extra int shifts every argument after it)."""
    src = (build.CSRC / f"{KERNEL}.cu").read_text()
    params = re.search(r"int flash_fwd\(([^)]*)\)", src).group(1).split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    want = [kinds[re.sub(r"\s+", "", p.rsplit(None, 1)[0]).removeprefix(
        "const")] for p in params]
    assert want == ARGTYPES


def test_ptxas_report_reads_registers_and_spills():
    """What chip_smoke.py gates on: each kernel's registers and spill
    bytes, from ``ptxas -v`` output as nvcc prints it for sm_90a."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z2tcILi256EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z2tcILi256EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3f32ILi32EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z3f32ILi32EEvPKf
    24 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
"""
    assert build.ptxas_report(log) == {"_Z2tcILi256EEvPKf": (254, 0),
                                       "_Z3f32ILi32EEvPKf": (64, 28)}
