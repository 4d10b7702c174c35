"""The port's ring and Ulysses attention and ``flash_attention_lse`` against
the JAX package's on the CPU.

The JAX side runs ``ring_attention``/``ulysses_attention`` inside
``shard_map`` over 4 devices of the conftest's CPU mesh, ``impl="xla"``
and ``impl="flash", interpret=True`` as ``tests/test_sequence_parallel.py``
does, with ``flash_attention_lse`` in interpret mode beside them: one
compiled program for every case (:func:`jax_cases`), at XLA's lowest
optimisation.  The port runs its plain twins (the flash inner through the
flash kernels' CPU twins), the 4 ranks of the ring driven in one process
(``loopback``); one test holds that loop bitwise against 4 gloo ranks as
threads, each with its own process group over one store.

Shape: B 1, S 512 (4 ranks of 128, the flash gate's least local length),
H 4, D 64 (a head dim the kernels take).  Limits are those of
``tests/test_sequence_parallel.py``: 2e-5 on the forward in f32, 5e-5 on
the gradients, 5e-2 in bf16.  Gradients are of ``sum(out * w)`` with a
seeded ``w``; ``flash_attention_lse`` also takes a nonzero seeded
cotangent on lse.
"""
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_distributed_training_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_attention_lse,
)
from pytorch_distributed_training_tpu.parallel import ring_attention as jax_ring
from pytorch_distributed_training_tpu.parallel import ulysses_attention as jax_ulysses
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_training_tpu_torch.parallel import GroupExchange, loopback, ring_attention
from pytorch_distributed_training_tpu_torch.parallel.sequence import (
    ring_attention_loop,
    ulysses_attention_loop,
)

N, B, S, H, D = 4, 1, 512, 4, 64
AXIS = "sequence"
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 5e-5, 5e-2
# XLA's CPU backend at its lowest optimisation on one thread (the JAX legs
# are small; compiling them is most of this file's cost)
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_parallel_codegen_split_count": 1, "xla_cpu_multi_thread_eigen": False}
CASES = [(kind, impl, causal) for kind in ("ring", "ulysses") for impl in ("xla", "flash")
         for causal in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    rng = np.random.default_rng(17)
    q, k, v, w = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    return q, k, v, w, rng.standard_normal((B, S, H)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_cases():
    """Each case's output and gradients of ``sum(out * w)`` from one
    compiled program: ``{(kind, impl, causal): (out, dq, dk, dv)}``, the
    bf16 rings under ``("ring", impl, "bf16")``, and ``"lse", causal``:
    ``(o, lse, dq, dk, dv)`` of ``flash_attention_lse`` with the lse
    cotangent."""
    mesh = Mesh(np.array(jax.devices()[:N]), (AXIS,))
    spec = P(None, AXIS, None, None)

    def sharded(kind, impl, causal):
        fn = jax_ring if kind == "ring" else jax_ulysses
        kw = {"impl": impl, "interpret": True} if impl == "flash" else {"impl": impl}
        return jax.shard_map(lambda a, b, c: fn(a, b, c, AXIS, causal=causal, **kw), mesh=mesh,
                             in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)

    def grads(f, q, k, v, w):
        def obj(a, b, c):
            out = f(a, b, c)
            return jnp.sum(out.astype(jnp.float32) * w), out
        (_, out), g = jax.value_and_grad(obj, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return (out, *g)

    def program(q, k, v, w, g_lse):
        res = {}
        for kind, impl, causal in CASES:
            res[f"{kind}-{impl}-{causal}"] = grads(sharded(kind, impl, causal), q, k, v, w)
        qb, kb, vb = (x.astype(jnp.bfloat16) for x in (q, k, v))
        for impl in ("xla", "flash"):
            res[f"ring-{impl}-bf16"] = grads(sharded("ring", impl, True), qb, kb, vb, w)
        for causal in (False, True):
            def obj(a, b, c, causal=causal):
                o, lse = jax_flash_attention_lse(a, b, c, causal=causal, interpret=True)
                return jnp.sum(o * w) + jnp.sum(lse * g_lse), (o, lse)
            (_, (o, lse)), g = jax.value_and_grad(obj, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            res[f"lse-{causal}"] = (o, lse, *g)
        return res

    args = tuple(jnp.asarray(x) for x in _inputs())
    out = jax.jit(program).lower(*args).compile(compiler_options=FAST_XLA)(*args)
    return {key: [np.asarray(x, np.float32) for x in val] for key, val in out.items()}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _loopback_grads(kind, impl, causal, dtype=torch.float32):
    """The port's 4 ranks in one process: (out, dq, dk, dv), global."""
    q, k, v, w, _ = _inputs()
    sl = S // N
    leaves = [[_t(x[:, r * sl:(r + 1) * sl], dtype).requires_grad_() for r in range(N)]
              for x in (q, k, v)]
    if kind == "ring":
        gens = [ring_attention_loop(leaves[0][r], leaves[1][r], leaves[2][r], N, r, causal,
                                    impl=impl) for r in range(N)]
    else:
        gens = [ulysses_attention_loop(leaves[0][r], leaves[1][r], leaves[2][r], N, causal,
                                       impl=impl) for r in range(N)]
    out = torch.cat(loopback(gens), 1)
    (out.float() * _t(w)).sum().backward()
    return [out.detach().float()] + [torch.cat([x.grad.float() for x in xs], 1) for xs in leaves]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("kind,impl,causal", CASES)
def test_matches_jax(jax_cases, kind, impl, causal):
    got = _loopback_grads(kind, impl, causal)
    want = jax_cases[f"{kind}-{impl}-{causal}"]
    _close(got[0], want[0], FWD_TOL, "out")
    for g, wg, name in zip(got[1:], want[1:], "qkv"):
        _close(g, wg, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_bf16_matches_jax(jax_cases, impl):
    got = _loopback_grads("ring", impl, True, torch.bfloat16)
    want = jax_cases[f"ring-{impl}-bf16"]
    for g, wg, name in zip(got, want, ("out", "dq", "dk", "dv")):
        _close(g, wg, BF16_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_lse_takes_the_lse_cotangent(jax_cases, causal):
    """The entry point (autograd through the kernels' CPU twins) and its
    plain twin :func:`flash_lse_plain` against JAX's in interpret mode:
    o, lse, dq, dk, dv with a nonzero cotangent on lse."""
    q, k, v, w, g_lse = _inputs()
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*leaves, causal=causal)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (B, S, H)
    ((o * _t(w)).sum() + (lse * _t(g_lse)).sum()).backward()
    got = [o.detach(), lse.detach()] + [x.grad for x in leaves]
    plain = tfa.flash_lse_plain(_t(q), _t(k), _t(v), _t(w), _t(g_lse), causal)
    want = jax_cases[f"lse-{causal}"]
    for g, p, wg, name in zip(got, plain, want, ("o", "lse", "dq", "dk", "dv")):
        torch.testing.assert_close(g, p, atol=0, rtol=0, msg=name)
        _close(g, wg, FWD_TOL if name in ("o", "lse") else GRAD_TOL, name)
    # without the fold the gradients move far past the limit
    dq_no_fold = tfa.flash_lse_plain(_t(q), _t(k), _t(v), _t(w), None, causal)[2]
    assert float((dq_no_fold - got[2]).abs().max()) > 100 * GRAD_TOL


def test_out_f32_counts_the_split_kernels():
    """``out_f32`` takes f32 dots (JAX ``:910-914``): a bf16 input at a
    resident shape counts as K2a + K2d/K2e, never the fused K2c."""
    bf16 = torch.bfloat16
    assert tfa.tpu_kernels(8192, 64, bf16, bf16_dots=False) == {
        "forward": "K2a", "dq": "K2d", "dkv": "K2e"}
    assert tfa.tpu_kernels(2048, 64, bf16)["dq"] == "K2c"
    assert tfa.tpu_kernels(32768, 64, bf16, bf16_dots=False)["forward"] == "K2b"
    # the entry point's o is f32 with out_f32, the input dtype without
    q = torch.zeros(1, 128, 1, 64, dtype=bf16)
    assert tfa.flash_attention_lse(q, q, q)[0].dtype == torch.float32
    assert tfa.flash_attention_lse(q, q, q, out_f32=False)[0].dtype == bf16
    assert tfa.flash_attention(q, q, q).dtype == bf16


def test_gloo_ranks_equal_the_loopback():
    """4 gloo ranks as threads, each with its process group over one store:
    the ring's forward and gradients bitwise the one-process loop's."""
    q, k, v, w, _ = _inputs()
    sl, store, outs, errors = S // N, dist.HashStore(), {}, []

    def rank(r):
        try:
            ex = GroupExchange(dist.ProcessGroupGloo(store, r, N, timedelta(seconds=60)))
            x = [_t(a[:, r * sl:(r + 1) * sl]).requires_grad_() for a in (q, k, v)]
            out = ring_attention(*x, ex, causal=True, impl="flash")
            (out * _t(w[:, r * sl:(r + 1) * sl])).sum().backward()
            outs[r] = [out.detach()] + [a.grad for a in x]
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(outs) == N, errors
    want = _loopback_grads("ring", "flash", True)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = torch.cat([outs[r][i] for r in range(N)], 1)
        torch.testing.assert_close(got, want[i], atol=0, rtol=0, msg=name)


def test_unknown_impl_and_heads_raise():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="impl"):
        loopback([ring_attention_loop(q, q, q, 1, 0, impl="pallas")])
    with pytest.raises(ValueError, match=r"heads \(2\) must be divisible by the axis size \(4\)"):
        loopback([ulysses_attention_loop(q, q, q, 4) for _ in range(4)])
