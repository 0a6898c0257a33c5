"""The leaf-by-leaf Adam(W) step that ``repro_torch.optim.adam``'s
multi-tensor update replaced, kept as the reference the tests hold the
new one to bit for bit (on the CPU in ``test_torch_compiled_step.py``,
on the card in ``test_torch_cuda.py``). Imports no JAX."""
import torch

from repro_torch.optim import adam


def per_leaf_updates(cfg, params, grads, state, *, inplace=False):
    """The leaf-by-leaf Adam(W) step the multi-tensor update replaced."""
    gn = adam.global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        if inplace:
            for g in adam.tree_leaves(grads):
                g.mul_(scale)
        else:
            grads = adam.tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    lr = adam.lr_at(cfg, step)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32, device=sf.device), sf)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, m, v):
        g32 = g.float()
        if inplace:
            m_n = m.mul_(b1).add_((1 - b1) * g32)
            v_n = v.mul_(b2).add_((1 - b2) * torch.square(g32))
        else:
            m_n = b1 * m + (1 - b1) * g32
            v_n = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m_n / bc1) / (torch.sqrt(v_n / bc2) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        p_n = p.float() - lr * delta
        return (p.copy_(p_n) if inplace else p_n.to(p.dtype)), m_n, v_n

    out = adam.tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: adam.tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), adam.AdamState(step, pick(1), pick(2))
