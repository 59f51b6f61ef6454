"""The port's ring attention (``ops/ring_attention.py``) against the JAX
package's on the CPU.

Four gloo processes (``tests/torch_dist_jobs.py ring``, one launch for the
module, 120 s limit) ring the JAX tests' inputs through ``sdpa`` with the
layout installed (the kernel partial: K1 / K2's plain versions here) and
through ``sp_sdpa(impl="reference")``; both are held to JAX ``ring_sdpa``
under ``shard_map`` on 4 virtual CPU devices, forward and every gradient,
at 2e-5.  In one process: the kernel partial's backward (K2's plain pieces
on delta - g_lse) against autograd of the plain partial, with and without
an lse cotangent; ``_combine``; the gates and ledger strings of
``sp_sdpa`` against the JAX ``sp_sdpa``.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from diff_sampler_tpu.ops import ring_attention as JRA
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.ops import ring_attention as RA
from diff_sampler_tpu_torch.parallel.launch import run_local

REPO = pathlib.Path(__file__).resolve().parents[1]
N_RANKS = 4
TOL = 2e-5


def _inputs(seed, b, t, h, d):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4)]


def _jax_ring(impl, q, k, v, cot, scale):
    """The JAX ring under shard_map over 4 devices: (out, dq, dk, dv) of
    sum(out * cot)."""
    mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("seq",))
    spec = P(None, "seq", None, None)
    ring = jax.shard_map(lambda a, b_, c: JRA.ring_sdpa(a, b_, c, scale, axis_name="seq",
                                                        impl=impl),
                         mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                         check_vma=False)
    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) * cot), argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    """The 4-process ring job's results by rank, and its inputs: the JAX
    forward test's [2, 256, 2, 16] and its gradient test's [1, 128, 2, 16]."""
    out = tmp_path_factory.mktemp("ring")
    cases = {"fwd": (_inputs(0, 2, 256, 2, 16), 0.25), "grad": (_inputs(1, 1, 128, 2, 16), 0.25)}
    for name, ((q, k, v, cot), scale) in cases.items():
        w = np.random.RandomState(2).standard_normal(q.shape).astype(np.float32)
        np.savez(out / f"ring_{name}.npz", q=q, k=k, v=v, cot=cot, w=w,
                 scale=np.float32(scale))
    (out / "spec.json").write_text(json.dumps({"out": str(out)}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = run_local(N_RANKS, ["tests/torch_dist_jobs.py", "ring", str(out / "spec.json")],
                        env=env, cwd=str(REPO), timeout_s=120)
    for rank, (code, text) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{text[-4000:]}"
    ranks = [dict(np.load(out / f"ring.rank{r}.npz")) for r in range(N_RANKS)]
    ledgers = [json.loads((out / f"ledger.rank{r}.json").read_text()) for r in range(N_RANKS)]
    return cases, ranks, ledgers


@pytest.mark.parametrize("case", ["fwd", "grad"])
@pytest.mark.parametrize("impl,jax_impl", [("reference", "einsum"), ("auto", "auto")])
def test_ring_matches_the_jax_ring(ring_job, case, impl, jax_impl):
    """Forward and dq / dk / dv of the 4-rank ring against the JAX ring;
    every rank holds the whole replicated result (the slice / gather
    conjugates), bit-equal across ranks."""
    cases, ranks, _ = ring_job
    (q, k, v, cot), scale = cases[case]
    want = _jax_ring(jax_impl, q, k, v, cot, scale)
    got = ranks[0]
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[f"{case}_{impl}_{name}"], w, atol=TOL, rtol=TOL,
                                   err_msg=name)
    for other in ranks[1:]:
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(other[f"{case}_{impl}_{name}"],
                                          got[f"{case}_{impl}_{name}"])


def test_ring_second_order_gradient_is_exact_on_the_cpu(ring_job):
    """d/d(q, k) of <grad_q <out, cot>, w> through the ring (the partials'
    recorded backward, the rotations and the slice / gather) against the
    plain attention's own second derivative in one process."""
    cases, ranks, _ = ring_job
    (q, k, v, cot), scale = cases["grad"]
    w = np.random.RandomState(2).standard_normal(q.shape).astype(np.float32)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = A.reference_sdpa(qt, kt, vt, scale)[0]
    gq, = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), qt, create_graph=True)
    (gq * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(ranks[0]["second_dq"], qt.grad.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ranks[0]["second_dk"], kt.grad.numpy(), atol=TOL, rtol=TOL)


def test_ring_ledger_matches_the_jax_ledger(ring_job):
    """sdpa under the 4-rank layout at the JAX gate of 256 tokens: T=256
    rings twice, T=64 (min tokens) and T=520 (local 130) do not, with the
    JAX ledger's strings (the JAX ``sp_sdpa`` on a seq=4 mesh)."""
    _, _, ledgers = ring_job
    mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("seq",))
    JRA.set_sp_context(mesh, seq_axis="seq", batch_axis=None)
    JRA.reset_sp_dispatch()
    try:
        for t in (256, 256, 64, 520):
            x = jax.ShapeDtypeStruct((1, t, 2, 16), jnp.float32)
            jax.eval_shape(lambda a: JRA.sp_sdpa(a, a, a, 0.25), x)  # the ledger is trace-time
        want = JRA.sp_dispatch_counts()
        lines = []
        JRA.log_sp_dispatch(lines.append)
    finally:
        JRA.set_sp_context(None)
        JRA.reset_sp_dispatch()
    for ledger in ledgers:
        assert ledger["rang"] == {repr(k): n for k, n in want["rang"].items()}
        assert ledger["skipped"] == {repr(k): r for k, r in want["skipped"].items()}
        assert ledger["line"] == lines[0]


GATE_TABLE = [  # (B, T, seq ranks)
    (1, 64, 4), (1, 256, 4), (1, 520, 4), (2, 256, 8), (1, 72, 8), (1, 264, 8),
    (1, 260, 8), (4, 4096, 2), (4, 1024, 2), (4, 256, 2), (4, 64, 2), (2, 4096, 4), (1, 256, 1),
]


@pytest.mark.parametrize("b,t,n", GATE_TABLE, ids=[f"B{b}-T{t}-seq{n}" for b, t, n in GATE_TABLE])
def test_sp_gate_matches_the_jax_sp_sdpa(b, t, n):
    """Ring or not, and the ledger's reason, as the JAX ``sp_sdpa`` decides
    on a seq=n mesh (its data axis absent: the port's batch is already its
    data row's)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    JRA.set_sp_context(mesh, seq_axis="seq", batch_axis=None)
    JRA.reset_sp_dispatch()
    try:
        x = jax.ShapeDtypeStruct((b, t, 1, 8), jnp.float32)
        rang = jax.eval_shape(lambda a: JRA.sp_sdpa(a, a, a, 0.5), x) is not None
        reason = JRA.sp_dispatch_counts()["skipped"].get((b, t, 1, 8))
    finally:
        JRA.set_sp_context(None)
        JRA.reset_sp_dispatch()
    assert RA.sp_gate(b, t, n) == (None if rang else reason)


def test_sp_sdpa_without_a_layout_leaves_sdpa_alone():
    rs = np.random.RandomState(3)
    q, k, v = (torch.as_tensor(rs.standard_normal((2, 64, 2, 8)).astype(np.float32))
               for _ in range(3))
    assert RA.sp_sdpa(q, k, v, 0.3) is None
    assert torch.equal(A.sdpa(q, k, v, 0.3), A._FlashAttentionMH.apply(q, k, v, 0.3))


@pytest.mark.parametrize("with_lse", [False, True], ids=["g_lse=0", "g_lse"])
def test_kernel_partial_backward_folds_the_lse_cotangent(with_lse):
    """The kernel partial's backward (K2's plain dQ and dK/dV on delta -
    g_lse) against autograd of the plain partial, with an lse cotangent and
    without; dropping the g_lse term misses by far more than the tolerance."""
    rs = np.random.RandomState(4)
    q, k, v = (rs.standard_normal((2, 48, 3, 16)).astype(np.float32) for _ in range(3))
    g_o = torch.as_tensor(rs.standard_normal((2, 48, 3, 16)).astype(np.float32))
    g_lse = torch.as_tensor(rs.standard_normal((2, 3, 48)).astype(np.float32) * 3.0)
    grads = {}
    for name, fn in (("kernel", RA._KernelPartial.apply), ("plain", RA._partial_reference)):
        xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        o, lse = fn(*xs, 0.3)
        loss = (o * g_o).sum() + ((lse * g_lse).sum() if with_lse else 0.0)
        loss.backward()
        grads[name] = [x.grad.numpy() for x in xs]
    for name, got, want in zip("qkv", grads["kernel"], grads["plain"]):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=name)
    if with_lse:
        # the term matters: the no-g_lse VJP is far from the true one in dq
        xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        o, _ = RA._partial_reference(*xs, 0.3)
        (o * g_o).sum().backward()
        assert np.abs(xs[0].grad.numpy() - grads["plain"][0]).max() > 100 * TOL


def test_partial_and_combine_match_jax():
    """The plain partial of two key blocks merged by ``_combine`` against
    the JAX ``_partial_einsum`` + ``_combine``, and against one whole
    softmax attention."""
    q, k, v, _ = _inputs(5, 1, 64, 2, 8)
    parts, jparts = [], []
    for sl in (slice(0, 32), slice(32, 64)):
        parts.append(RA._partial_reference(*(torch.as_tensor(x) for x in (q, k[:, sl], v[:, sl])),
                                           0.3))
        jparts.append(JRA._partial_einsum(q, k[:, sl], v[:, sl], 0.3))
    o, lse = RA._combine(*parts[0], *parts[1])
    jo, jlse = JRA._combine(*jparts[0], *jparts[1])
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-6, rtol=1e-6)
    whole = A.reference_sdpa(*(torch.as_tensor(x) for x in (q, k, v)), 0.3)[0]
    np.testing.assert_allclose(o.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)


def test_ring_of_one_rank_is_the_partial():
    q, k, v, _ = _inputs(6, 1, 32, 2, 8)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    for impl in ("auto", "reference"):
        got = RA.ring_sdpa(qt, kt, vt, 0.3, impl=impl)
        want = A.reference_sdpa(qt, kt, vt, 0.3)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        RA.ring_sdpa(qt, kt, vt, impl="einsum")


def test_auto_ring_takes_the_kernel_partial_at_any_head_dim(monkeypatch):
    """impl="auto" always runs the kernel partial: on a CPU tensor K1's
    plain version at any head dim, and off the CPU the kernel's own checks,
    so a head dim K1 refuses raises there as the local path does (a meta
    tensor stands in for a device without a plain route)."""
    calls = []
    real = A.flash_attention_mh

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return real(q, k, v, scale)

    monkeypatch.setattr(A, "flash_attention_mh", spy)
    q, k, v, _ = _inputs(7, 1, 32, 2, 12)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    got = RA.ring_sdpa(qt, kt, vt, 0.3)
    assert calls == [(1, 32, 2, 12)]
    np.testing.assert_allclose(got.numpy(), A.reference_sdpa(qt, kt, vt, 0.3)[0].numpy(),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="no attention kernel"):
        RA.ring_sdpa(*(x.to("meta") for x in (qt, kt, vt)), 0.3)
