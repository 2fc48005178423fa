"""Optimizer update ops (phi ``sgd_``/``adam_``/... ops).

Port of ``paddle_tpu/ops/optim_ops.py``.  As there, every op is a pure
function returning the updated state; the trailing underscore names are
kept for registry parity, and a caller holding Paddle Tensors gets new
Tensors back (the ``optimizer`` classes update in place instead).  The
arithmetic is the JAX ops', in f32 where they compute in f32.
"""

import torch

from .registry import op

_f32 = torch.float32


def _f(v, ref):
    """``jnp.asarray(v, f32)`` on ``ref``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(_f32)
    return torch.as_tensor(v, dtype=_f32, device=ref.device)


def _master(param, master_param, multi_precision):
    return (master_param if multi_precision and master_param is not None
            else param).to(_f32)


@op("sgd_")
def sgd_(param, learning_rate, grad, master_param=None,
         multi_precision=False):
    dt = torch.promote_types(param.dtype, _f32)
    lr = (learning_rate.to(dt) if isinstance(learning_rate, torch.Tensor)
          else torch.as_tensor(learning_rate, dtype=dt, device=param.device))
    if multi_precision and master_param is not None:
        new_master = master_param - lr * grad.to(master_param.dtype)
        return new_master.to(param.dtype), new_master
    return param - (lr * grad).to(param.dtype), master_param


@op("momentum_")
def momentum_(param, grad, velocity, learning_rate, master_param=None,
              mu=0.9, use_nesterov=False, regularization_method="",
              regularization_coeff=0.0, multi_precision=False,
              rescale_grad=1.0):
    g = grad.to(_f32) * rescale_grad
    p = _master(param, master_param, multi_precision)
    if regularization_method == "l2_decay":
        g = g + regularization_coeff * p
    v = mu * velocity + g
    lr = _f(learning_rate, param)
    p_new = p - lr * (g + mu * v) if use_nesterov else p - lr * v
    if multi_precision and master_param is not None:
        return p_new.to(param.dtype), v, p_new
    return p_new.to(param.dtype), v.to(velocity.dtype), master_param


def _adam_core(p, g, m1, m2, b1p, b2p, lr, beta1, beta2, eps):
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * g * g
    denom = torch.sqrt(m2n) / torch.sqrt(1 - b2p) + eps
    return p - lr * (m1n / (1 - b1p)) / denom, m1n, m2n


def _adam_outs(param, p0, p_new, m1n, m2n, b1p, b2p, moment1, moment2,
               beta1_pow, beta2_pow, skip_update, master_param,
               multi_precision):
    if skip_update is not None:
        skip = skip_update.reshape(())
        p_new = torch.where(skip, p0, p_new)
        m1n = torch.where(skip, moment1, m1n)
        m2n = torch.where(skip, moment2, m2n)
        b1p = torch.where(skip, beta1_pow, b1p)
        b2p = torch.where(skip, beta2_pow, b2p)
    outs = (p_new.to(param.dtype), m1n.to(moment1.dtype),
            m2n.to(moment2.dtype),
            b1p.to(beta1_pow.dtype).reshape(beta1_pow.shape),
            b2p.to(beta2_pow.dtype).reshape(beta2_pow.shape))
    if multi_precision and master_param is not None:
        return outs + (p_new,)
    return outs + (master_param,)


@op("adam_")
def adam_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow,
          master_param=None, skip_update=None, beta1=0.9, beta2=0.999,
          epsilon=1e-8, lazy_mode=False, min_row_size_to_use_multithread=1000,
          multi_precision=False, use_global_beta_pow=False):
    p = _master(param, master_param, multi_precision)
    b1p_in, b2p_in = _f(beta1_pow, param), _f(beta2_pow, param)
    # bias correction uses the INPUT pows; the outputs advance them
    p_new, m1n, m2n = _adam_core(p, grad.to(_f32), moment1.to(_f32),
                                 moment2.to(_f32), b1p_in, b2p_in,
                                 _f(learning_rate, param), beta1, beta2,
                                 epsilon)
    return _adam_outs(param, p, p_new, m1n, m2n, b1p_in * beta1,
                      b2p_in * beta2, moment1, moment2, beta1_pow,
                      beta2_pow, skip_update, master_param, multi_precision)


@op("adamw_")
def adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow,
           master_param=None, skip_update=None, beta1=0.9, beta2=0.999,
           epsilon=1e-8, lr_ratio=1.0, coeff=0.01, with_decay=True,
           lazy_mode=False, min_row_size_to_use_multithread=1000,
           multi_precision=False, use_global_beta_pow=False):
    p0 = _master(param, master_param, multi_precision)
    lr = _f(learning_rate, param) * lr_ratio
    p = p0 * (1.0 - lr * coeff) if with_decay else p0
    b1p_in, b2p_in = _f(beta1_pow, param), _f(beta2_pow, param)
    p_new, m1n, m2n = _adam_core(p, grad.to(_f32), moment1.to(_f32),
                                 moment2.to(_f32), b1p_in, b2p_in, lr,
                                 beta1, beta2, epsilon)
    return _adam_outs(param, p0, p_new, m1n, m2n, b1p_in * beta1,
                      b2p_in * beta2, moment1, moment2, beta1_pow,
                      beta2_pow, skip_update, master_param, multi_precision)


@op("adamax_")
def adamax_(param, grad, learning_rate, moment, inf_norm, beta1_pow,
            master_param=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
            multi_precision=False):
    g = grad.to(_f32)
    m = beta1 * moment.to(_f32) + (1 - beta1) * g
    u = torch.maximum(beta2 * inf_norm.to(_f32), torch.abs(g))
    p_new = param.to(_f32) - _f(learning_rate, param) / \
        (1 - _f(beta1_pow, param)) * m / (u + epsilon)
    return (p_new.to(param.dtype), m.to(moment.dtype),
            u.to(inf_norm.dtype), master_param)


@op("adagrad_")
def adagrad_(param, grad, moment, learning_rate, master_param=None,
             epsilon=1e-6, multi_precision=False):
    g = grad.to(_f32)
    mom = moment.to(_f32) + g * g
    p_new = param.to(_f32) - _f(learning_rate, param) * g / \
        (torch.sqrt(mom) + epsilon)
    return (p_new.to(param.dtype), mom.to(moment.dtype), master_param)


@op("adadelta_")
def adadelta_(param, grad, avg_squared_grad, avg_squared_update,
              learning_rate=1.0, master_param=None, rho=0.95, epsilon=1e-6,
              multi_precision=False):
    g = grad.to(_f32)
    asg = rho * avg_squared_grad.to(_f32) + (1 - rho) * g * g
    update = -torch.sqrt(avg_squared_update.to(_f32) + epsilon) / \
        torch.sqrt(asg + epsilon) * g
    asu = rho * avg_squared_update.to(_f32) + (1 - rho) * update * update
    p_new = param.to(_f32) + _f(learning_rate, param) * update
    return (p_new.to(param.dtype), asg.to(avg_squared_grad.dtype),
            asu.to(avg_squared_update.dtype), master_param)


@op("rmsprop_")
def rmsprop_(param, mean_square, grad, moment, learning_rate,
             mean_grad=None, master_param=None, epsilon=1e-10, decay=0.9,
             momentum=0.0, centered=False, multi_precision=False):
    g = grad.to(_f32)
    ms = decay * mean_square.to(_f32) + (1 - decay) * g * g
    lr = _f(learning_rate, param)
    if centered and mean_grad is not None:
        mg = decay * mean_grad.to(_f32) + (1 - decay) * g
        denom = torch.sqrt(ms - mg * mg + epsilon)
    else:
        mg = mean_grad
        denom = torch.sqrt(ms + epsilon)
    mom = momentum * moment.to(_f32) + lr * g / denom
    p_new = param.to(_f32) - mom
    return (p_new.to(param.dtype), mom.to(moment.dtype),
            ms.to(mean_square.dtype),
            mg if mg is None or not centered else mg.to(mean_grad.dtype),
            master_param)


@op("lamb_")
def lamb_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow,
          master_param=None, skip_update=None, weight_decay=0.01, beta1=0.9,
          beta2=0.999, epsilon=1e-6, always_adapt=False,
          multi_precision=False):
    p = _master(param, master_param, multi_precision)
    g = grad.to(_f32)
    m1n = beta1 * moment1.to(_f32) + (1 - beta1) * g
    m2n = beta2 * moment2.to(_f32) + (1 - beta2) * g * g
    b1p_in, b2p_in = _f(beta1_pow, param), _f(beta2_pow, param)
    r = (m1n / (1 - b1p_in)) / (torch.sqrt(m2n / (1 - b2p_in)) + epsilon) \
        + weight_decay * p
    w_norm = torch.linalg.vector_norm(p)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    p_new = p - _f(learning_rate, param) * trust * r
    outs = (p_new.to(param.dtype), m1n.to(moment1.dtype),
            m2n.to(moment2.dtype),
            (b1p_in * beta1).to(beta1_pow.dtype).reshape(beta1_pow.shape),
            (b2p_in * beta2).to(beta2_pow.dtype).reshape(beta2_pow.shape))
    if multi_precision and master_param is not None:
        return outs + (p_new,)
    return outs + (master_param,)


# ---- merged / fused list variants: loops over the single-param ops ----

def _listify(x, n):
    if x is None:
        return [None] * n
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * n


@op("merged_adam_")
def merged_adam_(params, grads, learning_rate, moments1, moments2,
                 beta1_pows, beta2_pows, master_params=None, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, multi_precision=False,
                 use_global_beta_pow=False):
    n = len(params)
    lrs, mps = _listify(learning_rate, n), _listify(master_params, n)
    outs = ([], [], [], [], [], [])
    for i in range(n):
        r = adam_(params[i], grads[i], lrs[i], moments1[i], moments2[i],
                  beta1_pows[i], beta2_pows[i], master_param=mps[i],
                  beta1=beta1, beta2=beta2, epsilon=epsilon,
                  multi_precision=multi_precision)
        for j in range(6):
            outs[j].append(r[j])
    return outs


@op("merged_momentum_")
def merged_momentum_(params, grads, velocitys, learning_rate,
                     master_params=None, mu=0.9, use_nesterov=False,
                     regularization_method=None, regularization_coeff=None,
                     multi_precision=False, rescale_grad=1.0):
    n = len(params)
    lrs, mps = _listify(learning_rate, n), _listify(master_params, n)
    rms = regularization_method or [""] * n
    rcs = regularization_coeff or [0.0] * n
    outs = ([], [], [])
    for i in range(n):
        r = momentum_(
            params[i], grads[i], velocitys[i], lrs[i], master_param=mps[i],
            mu=mu, use_nesterov=use_nesterov,
            regularization_method=rms[i] if i < len(rms) else "",
            regularization_coeff=rcs[i] if i < len(rcs) else 0.0,
            multi_precision=multi_precision, rescale_grad=rescale_grad)
        for j in range(3):
            outs[j].append(r[j])
    return outs


@op("fused_adam_")
def fused_adam_(params, grads, learning_rate, moments1, moments2,
                beta1_pows, beta2_pows, master_params=None,
                skip_update=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                chunk_size=32768, weight_decay=0.0, use_adamw=False,
                multi_precision=False, use_global_beta_pow=False):
    n = len(params)
    mps = _listify(master_params, n)
    outs = ([], [], [], [], [], [])
    for i in range(n):
        args = (params[i], grads[i], learning_rate, moments1[i],
                moments2[i], beta1_pows[i], beta2_pows[i])
        kw = dict(master_param=mps[i], skip_update=skip_update, beta1=beta1,
                  beta2=beta2, epsilon=epsilon,
                  multi_precision=multi_precision)
        r = (adamw_(*args, coeff=weight_decay, with_decay=weight_decay > 0.0,
                    **kw) if use_adamw else adam_(*args, **kw))
        for j in range(6):
            outs[j].append(r[j])
    return outs


# ---- AMP loss-scaling ops ----

@op("check_finite_and_unscale_")
def check_finite_and_unscale_(xs, scale):
    inv = 1.0 / _f(scale, xs[0])
    found_inf = torch.zeros((), dtype=torch.bool, device=xs[0].device)
    outs = []
    for x in xs:
        xf = x.to(_f32) * inv
        found_inf = found_inf | ~torch.isfinite(xf).all()
        outs.append(xf.to(x.dtype))
    return outs, found_inf.reshape((1,))


@op("update_loss_scaling_")
def update_loss_scaling_(xs, found_infinite, prev_loss_scaling,
                         in_good_steps, in_bad_steps, incr_every_n_steps=2000,
                         decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                         decr_ratio=0.5, stop_update=False):
    found = found_infinite.reshape(()).to(torch.bool)
    good = in_good_steps.reshape(()).to(torch.int32)
    bad = in_bad_steps.reshape(()).to(torch.int32)
    scale = _f(prev_loss_scaling, found).reshape(())
    zero = torch.zeros_like(good)
    bad_new = torch.where(found, bad + 1, zero)
    good_new = torch.where(found, zero, good + 1)
    shrink = bad_new >= decr_every_n_nan_or_inf
    grow = good_new >= incr_every_n_steps
    scale_new = torch.where(shrink, torch.clamp(scale * decr_ratio, min=1.0),
                            scale)
    scale_new = torch.where(grow, scale * incr_ratio, scale_new)
    bad_new = torch.where(shrink, zero, bad_new)
    good_new = torch.where(grow, zero, good_new)
    # a device flag is selected on the device, never read on the host
    if isinstance(stop_update, (bool, int)):
        if stop_update:
            scale_new, good_new, bad_new = scale, good, bad
    else:
        stop = stop_update.reshape(()).to(torch.bool)
        scale_new = torch.where(stop, scale, scale_new)
        good_new = torch.where(stop, good, good_new)
        bad_new = torch.where(stop, bad, bad_new)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in xs]
    return (outs, scale_new.reshape((1,)), good_new.reshape((1,)),
            bad_new.reshape((1,)))


@op("average_accumulates_")
def average_accumulates_(param, in_sum_1, in_sum_2, in_sum_3,
                         in_num_accumulates, in_old_num_accumulates,
                         in_num_updates, average_window=10000,
                         max_average_window=10000, min_average_window=10000):
    num_acc = in_num_accumulates.reshape(()) + 1
    num_upd = in_num_updates.reshape(()) + 1
    old_num = in_old_num_accumulates.reshape(())
    s1 = in_sum_1 + param
    s2, s3 = in_sum_2, in_sum_3
    window = torch.clamp(torch.clamp(num_upd * average_window,
                                     min=min_average_window),
                         max=max_average_window).to(num_acc.dtype)
    roll = num_acc + old_num >= window
    s2_new = torch.where(roll, s1 + s2, s2)
    s1_new = torch.where(roll, torch.zeros_like(s1), s1)
    s3_new = torch.where(roll, torch.zeros_like(s3), s3)
    old_new = torch.where(roll, num_acc + old_num, old_num)
    num_new = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return (s1_new, s2_new, s3_new, num_new.reshape((1,)),
            old_new.reshape((1,)), num_upd.reshape((1,)))
