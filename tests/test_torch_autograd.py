"""The port's ``paddle.autograd`` surface against the reference's
(``paddle_tpu/autograd/{__init__,tape,pylayer}.py``) on the CPU: ``grad``
and ``backward`` (``allow_unused``, ``no_grad_vars``, ``create_graph``,
``retain_graph``), the grad modes, ``PyLayer``, ``jacobian`` and
``hessian``, each within 1e-6 of the reference on the same numpy inputs.
The reference's ``grad`` has no ``no_grad_vars``: there the cut tensor is
detached by hand, which is what the option means."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _both(arrays):
    """The arrays as reference tensors and as port tensors, all requiring
    grad."""
    j = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    return j, t


def _np(x):
    return x.numpy() if isinstance(x, paddle.Tensor) else x.detach().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _f(lib, x, y):
    return (lib.tanh(x) * y).sum() + (x * x).sum()


def test_grad_matches_reference():
    (jx, jy), (tx, ty) = _both(_inputs(0, (3, 4), (3, 4)))
    jg = paddle.grad(_f(paddle, jx, jy), [jx, jy])
    tg = pt.grad(_f(torch, tx, ty), [tx, ty])
    for a, b in zip(tg, jg):
        _close(a, b)
    assert tx.grad is None and ty.grad is None     # .grad untouched


def test_grad_outputs_seed_the_vector_jacobian_product():
    (jx, w), (tx, _) = _both(_inputs(1, (5,), (5,)))
    jw, tw = paddle.to_tensor(_np(w)), torch.tensor(_np(w))
    (jg,) = paddle.grad(paddle.sin(jx) * 3.0, jx, grad_outputs=jw)
    (tg,) = pt.grad(torch.sin(tx) * 3.0, tx, grad_outputs=tw)
    _close(tg, jg)


def test_allow_unused():
    (jx, jy), (tx, ty) = _both(_inputs(2, (3,), (3,)))
    with pytest.raises(ValueError):
        paddle.grad((jx * 2).sum(), [jx, jy])
    with pytest.raises(ValueError, match="allow_unused"):
        pt.grad((tx * 2).sum(), [tx, ty])
    jg = paddle.grad((jx * 2).sum(), [jx, jy], allow_unused=True)
    tg = pt.grad((tx * 2).sum(), [tx, ty], allow_unused=True)
    assert jg[1] is None and tg[1] is None
    _close(tg[0], jg[0])


def test_no_grad_vars_cut_the_tensor():
    (jx,), (tx,) = _both(_inputs(3, (4,)))
    jh = paddle.exp(jx).detach()        # the reference: cut by hand
    (jg,) = paddle.grad((jh * jx + jh).sum(), jx)
    th = torch.exp(tx)
    (tg,) = pt.grad((th * tx + th).sum(), tx, no_grad_vars=[th])
    _close(tg, jg)                      # exp(x): only the ``* x`` path


def test_create_graph_gives_a_differentiable_grad():
    (jx,), (tx,) = _both(_inputs(4, (6,)))
    (jg,) = paddle.grad((jx ** 3).sum(), jx, create_graph=True)
    (tg,) = pt.grad((tx ** 3).sum(), tx, create_graph=True)
    _close(tg, jg)
    (jgg,) = paddle.grad(jg.sum(), jx)
    (tgg,) = pt.grad(tg.sum(), tx)
    _close(tgg, jgg)                    # 6 x


def test_retain_graph_follows_create_graph():
    tx = torch.tensor(_inputs(5, (3,))[0], requires_grad=True)
    y = (tx.exp() * tx).sum()
    pt.grad(y, tx)                      # retain_graph=None, create_graph off
    with pytest.raises(RuntimeError):
        pt.grad(y, tx)
    y = (tx.exp() * tx).sum()
    pt.grad(y, tx, create_graph=True)   # retain_graph None -> True
    pt.grad(y, tx)


def test_backward_accumulates_into_leaves():
    (jx, jy), (tx, ty) = _both(_inputs(6, (2, 3), (2, 3)))
    jz, tz = _f(paddle, jx, jy), _f(torch, tx, ty)
    seed = np.float32(0.5)
    paddle.autograd.backward([jz], [paddle.to_tensor(seed)])
    pt.autograd.backward([tz], [torch.tensor(seed)])
    _close(tx.grad, jx.grad)
    _close(ty.grad, jy.grad)


def test_grad_modes_are_context_managers_and_decorators():
    tx = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert (tx * 2).requires_grad
    assert pt.is_grad_enabled()

    @pt.no_grad()
    def f(x):
        return x * 2

    assert not f(tx).requires_grad
    with pt.set_grad_enabled(False):
        assert not (tx * 2).requires_grad
    assert pt.is_grad_enabled()


def _pylayer(lib, base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x, scale=2.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x ** 3 * scale

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3 * x ** 2 * ctx.scale + 1.0    # +1: not autograd's

    return Cube


def test_pylayer_uses_its_own_backward():
    (jx,), (tx,) = _both(_inputs(7, (5,)))
    jc, tc = (_pylayer(paddle, paddle.autograd.PyLayer),
              _pylayer(torch, pt.autograd.PyLayer))
    jy, ty = jc.apply(jx, scale=1.5), tc.apply(tx, scale=1.5)
    _close(ty, jy)
    jy.sum().backward()
    ty.sum().backward()
    _close(tx.grad, jx.grad)


def test_pylayer_context_names():
    seen = {}

    class Two(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, n):
            ctx.save_for_backward(x)
            ctx.mark_not_inplace(x)
            ctx.set_materialize_grads(True)
            idx = torch.arange(x.shape[0])
            ctx.mark_non_differentiable(idx)
            return x * n, idx

        @staticmethod
        def backward(ctx, dy, didx):
            seen["saved"] = ctx.saved_tensor()     # Paddle's method form
            return dy * 2

    x = torch.ones(3, requires_grad=True)
    y, idx = Two.apply(x, 2)
    assert not idx.requires_grad
    y.sum().backward()
    assert torch.equal(seen["saved"][0], x.detach())
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def _poly(lib):
    return lambda a: lib.stack([a[0] * a[1], a[1] ** 3, lib.sin(a[0])])


def test_jacobian_and_hessian_match_reference():
    (x,) = _inputs(8, (2,))
    jj = paddle.autograd.jacobian(_poly(paddle), paddle.to_tensor(x))
    tj = pt.autograd.jacobian(_poly(torch), torch.tensor(x))
    assert tj.shape == jj.shape == [3, 2]
    np.testing.assert_allclose(tj.numpy(), jj.numpy(), **TOL)
    _close(tj[0], jj[0])
    jh = paddle.autograd.hessian(_poly(paddle), paddle.to_tensor(x))
    th = pt.autograd.hessian(_poly(torch), torch.tensor(x))
    np.testing.assert_allclose(th.numpy(), jh.numpy(), **TOL)
    with pytest.raises(NotImplementedError):
        pt.autograd.jacobian(torch.ones(2), torch.ones(2))


def test_batched_jacobian_matches_reference():
    (x,) = _inputs(9, (3, 2))
    jj = paddle.autograd.jacobian(lambda a: a * a.sum(-1, keepdim=True),
                                  paddle.to_tensor(x), batch_axis=0)
    tj = pt.autograd.jacobian(lambda a: a * a.sum(-1, keepdim=True),
                              torch.tensor(x), batch_axis=0)
    assert tj.shape == jj.shape
    np.testing.assert_allclose(tj.numpy(), jj.numpy(), **TOL)
