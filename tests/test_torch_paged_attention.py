"""Parity of the port's paged decode attention with the JAX reference.

The same seeded numpy inputs go through ``paddle_tpu``'s Pallas decode
kernel in interpret mode and its dense reference, and through
``paddle_tpu_torch``'s plain version of the CUDA kernel (what a CPU
tensor runs) and its dense reference.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's own tolerance for its kernel (test_paged_attention.py)
TOL = dict(rtol=2e-5, atol=2e-5)


def _tables_contiguous(batch, pps):
    return (np.arange(batch)[:, None] * pps
            + np.arange(pps)[None, :]).astype(np.int32)


def _tables_shared(batch, pps):
    """Permuted pages, rows 1 and 2 sharing their first two pages, unused
    entries 0."""
    t = np.zeros((batch, pps), np.int32)
    perm = np.random.RandomState(3).permutation(np.arange(1, batch * pps))
    t[:, :pps - 1] = perm[:batch * (pps - 1)].reshape(batch, pps - 1)
    t[2, :2] = t[1, :2]
    return t


# (batch, heads, kv_heads, d, page, pages_per_seq, ctx, tables)
CASES = {
    "gqa_ragged": (3, 8, 4, 64, 8, 4, (5, 17, 32), _tables_contiguous),
    # ctx 1, one full page, a page plus one, and a multiple of the page
    "shared_pages": (4, 4, 1, 32, 8, 5, (1, 8, 9, 32), _tables_shared),
    "mha_one_page": (2, 2, 2, 16, 16, 2, (16, 3), _tables_contiguous),
}


def _inputs(name):
    batch, heads, kvh, d, page, pps, ctx, tables = CASES[name]
    rng = np.random.RandomState(len(name))
    n_pages = batch * pps + 1
    q = rng.randn(batch, heads, d).astype(np.float32)
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    return q, kp, vp, tables(batch, pps), np.asarray(ctx, np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_interpret_kernel(name):
    q, kp, vp, tbl, ctx = _inputs(name)
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tbl),
                               jnp.asarray(ctx), interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(tbl),
                              torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_references_agree(name):
    """The port's dense oracle matches the JAX one, and the plain kernel
    recurrence matches the port's oracle (tables given as numpy)."""
    q, kp, vp, tbl, ctx = _inputs(name)
    want = jpa.paged_attention_reference(jnp.asarray(q), jnp.asarray(kp),
                                         jnp.asarray(vp), tbl, ctx)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    ref = tpa.paged_attention_reference(tq, tk, tv, tbl, ctx)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tpa.paged_attention(tq, tk, tv, tbl,
                                                   ctx).numpy(),
                               ref.numpy(), **TOL)


def test_bf16_plain_accumulates_in_fp32():
    """A bf16 input runs the same fp32 recurrence and rounds once."""
    q, kp, vp, tbl, ctx = _inputs("gqa_ragged")
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
    got = tpa.paged_attention(tq, tk, tv, tbl, ctx)
    ref = tpa.paged_attention(tq.float(), tk.float(), tv.float(), tbl, ctx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.bfloat16().float().numpy())


def test_int8_pages_are_a_later_slice():
    """int8 pages, a later slice than the native ones, now decode through
    B5's plain version, matching the reference's quantised kernel in
    interpret mode (the full parity cases are in
    ``tests/test_torch_kv_int8.py``); one scale array alone raises."""
    from paddle_tpu.models.generation import quantize_kv_rows
    q, kp, vp, tbl, ctx = _inputs("mha_one_page")
    (kq, ks), (vq, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
    want = jpa.paged_attention(jnp.asarray(q), kq, vq, jnp.asarray(tbl),
                               jnp.asarray(ctx), k_scales=ks, v_scales=vs,
                               interpret=True)
    kq, ks, vq, vs = (torch.from_numpy(np.array(a))
                      for a in (kq, ks, vq, vs))
    got = tpa.paged_attention(torch.from_numpy(q), kq, vq, tbl, ctx,
                              k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(torch.from_numpy(q), kq, vq, tbl, ctx,
                            k_scales=ks)
