"""Ancestral sequence reconstruction and site rates (the RateAncestor
outputs; the reference's rst file).

Port of `paml_tpu/apps/ancestral.py`:

- marginal reconstruction (empirical Bayes): each internal node's state
  posteriors from its inside partials times its outside partials
  (reference: AncestralMarginal, src/treesub.c:6288; ProbSitePattern
  :6064);
- joint reconstruction: the max-product dynamic program of Pupko et al.
  (2000) (reference: AncestralJointPPSG2000, src/treesub.c:6964), over all
  site patterns at once;
- site rates: the posterior mean rate of each pattern under a rate
  mixture (reference: lfunRates, src/treesub.c:7314).

The JAX package's two `lax.scan` sweeps over the nodes become loops over
the levels of the pruning schedule (`pruning._levels`), one batched
operation per level and number of children.  The inside partials are the
scaled partials the level path stores (`pruning._forward_levels`).  This
runs on the device of its inputs; no kernel computes it, as no pruning
kernel returns per-node posteriors.  Shapes follow `core/pruning.py`: P
[nnode, C, n, n] (row = parent state), pi [C, n].
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import pruning
from ..core.topology import Topology


def _dense_tips(tips, dtype, n: int) -> torch.Tensor:
    """Tip partials [ns, H, n] from state codes, TipCodes or partials."""
    tipsT = pruning._tipsT_of(tips, dtype)
    if tipsT.dim() == 2:
        return torch.nn.functional.one_hot(tipsT, n).to(dtype)
    return tipsT.transpose(-1, -2)


def _loo(kid_c: torch.Tensor) -> torch.Tensor:
    """Leave-one-out products over the child axis 1 of [W, K, ...]."""
    K = kid_c.shape[1]
    pre = [torch.ones_like(kid_c[:, 0])]
    for k in range(1, K):
        pre.append(pre[-1] * kid_c[:, k - 1])
    suf = [torch.ones_like(kid_c[:, 0])]
    for k in range(K - 2, -1, -1):
        suf.insert(0, suf[0] * kid_c[:, k + 1])
    return torch.stack([pre[k] * suf[k] for k in range(K)], dim=1)


def inside_outside(P, tips, topo: Topology, pi) -> torch.Tensor:
    """State posteriors of the internal nodes, [n_internal, C, H, n]
    normalized over n (node v at row v - ns): the level sweep of the
    likelihood up, then the outside recursion of the adjoint down."""
    ns, nnode = topo.ns, topo.nnode
    C, n = P.shape[1], P.shape[3]
    with torch.no_grad():
        s, _, c = pruning._forward_levels(
            P, pruning._tipsT_of(tips, P.dtype), topo)
        H = s[topo.root].shape[-1]
        W = {topo.root: pi[:, :, None].expand(C, n, H)}
        for level in reversed(pruning._levels(topo)):
            for K, grp in pruning._arity_groups(level).items():
                nw = len(grp)
                kidflat = [k for _, kids in grp for k in kids]
                kid_c = torch.stack([c[k] for k in kidflat])
                G = (torch.stack([W[node] for node, _ in grp])[:, None]
                     * _loo(kid_c.reshape(nw, K, C, n, H)))
                Pk = P[torch.as_tensor(kidflat, device=P.device)]
                Wk = torch.einsum("wkcjh,wkcji->wkcih", G,
                                  Pk.reshape(nw, K, C, n, n))
                # rescaled against under/overflow; posteriors renormalize
                mx = Wk.amax(dim=-2, keepdim=True)
                Wk = Wk / torch.where(mx > 0, mx, torch.ones_like(mx))
                for w, (_, kids) in enumerate(grp):
                    for k, kid in enumerate(kids):
                        if kid >= ns:
                            W[kid] = Wk[w, k]
        post = torch.stack([s[v] * W[v] for v in range(ns, nnode)])
        post = post / torch.clamp_min(post.sum(-2, keepdim=True),
                                      torch.finfo(P.dtype).tiny)
    return post.transpose(-1, -2)


def marginal_reconstruction(P, tips, topo: Topology, pi, class_w, fpatt):
    """The best state and its probability per (internal node, pattern),
    the classes mixed by their posterior weights: numpy (best [nint, H],
    prob [nint, H], post [nint, H, n])."""
    post_c = inside_outside(P, tips, topo, pi)              # [nint,C,H,n]
    with torch.no_grad():
        cls_post = pruning.site_class_posterior(P, tips, topo, pi, class_w)
        post = torch.einsum("ichn,ch->ihn", post_c, cls_post)
        prob, best = post.max(dim=-1)
    return best.cpu().numpy(), prob.cpu().numpy(), post.cpu().numpy()


def joint_reconstruction(P, tips, topo: Topology, pi):
    """Pupko et al. (2000) joint ML reconstruction for a single class:
    P [nnode, 1, n, n].  Returns numpy (states [nint, H], lnP [H], the
    joint log-probability)."""
    ns = topo.ns
    P1 = P[:, 0]
    n = P1.shape[-1]
    with torch.no_grad():
        logP = torch.log(torch.clamp_min(P1, 1e-300))        # [nnode, n, n]
        log_tips = torch.log(torch.clamp_min(
            _dense_tips(tips, P1.dtype, n), 1e-300))        # [ns, H, n]

        def L_of(v):
            return log_tips[v] if v < ns else L[v]

        # upward: L[v][h, j] = best log-probability of v's subtree given
        # v's state j; arg[k][h, j] = the best state of child k given its
        # parent's state j
        L: dict[int, torch.Tensor] = {}
        arg: dict[int, torch.Tensor] = {}
        levels = pruning._levels(topo)
        for level in levels[:-1]:          # the last level is the root
            for K, grp in pruning._arity_groups(level).items():
                kidflat = [k for _, kids in grp for k in kids]
                Lc = torch.stack([L_of(k) for k in kidflat])  # [WK, H, s]
                Pk = logP[torch.as_tensor(kidflat, device=P1.device)]
                Mk, ak = (Pk[:, None] + Lc[:, :, None, :]).max(dim=-1)
                Mk = Mk.reshape((len(grp), K) + Mk.shape[1:])
                for w, (node, kids) in enumerate(grp):
                    L[node] = Mk[w].sum(0)
                    for k, kid in enumerate(kids):
                        arg[kid] = ak[w * K + k]
        # the root: log pi plus each child's best path, in child order
        root = topo.root
        kids = [int(k) for k in topo.children[root] if k >= 0]
        logpi = torch.log(torch.clamp_min(pi[0] if pi.dim() == 2 else pi,
                                          1e-300))
        H = log_tips.shape[1]
        total = logpi[None, :].expand(H, n)
        for k in kids:
            Mk, ak = (logP[k][None] + L_of(k)[:, None, :]).max(dim=-1)
            total = total + Mk
            arg[k] = ak
        lnP, root_state = total.max(dim=-1)
        # downward traceback
        states = {root: root_state}
        for level in reversed(levels):
            for node, node_kids in level:
                for kid in node_kids:
                    if kid >= ns:
                        states[kid] = torch.gather(
                            arg[kid], 1, states[node][:, None])[:, 0]
        out = torch.stack([states[v] for v in range(ns, topo.nnode)])
    return out.cpu().numpy().astype(np.int32), lnP.cpu().numpy()


def site_rates(P, tips, topo: Topology, pi, class_w, rates) -> np.ndarray:
    """The posterior mean rate of each pattern under the rate mixture
    (reference: lfunRates, src/treesub.c:7314)."""
    with torch.no_grad():
        cls_post = pruning.site_class_posterior(P, tips, topo, pi, class_w)
        r = torch.as_tensor(rates, dtype=cls_post.dtype,
                            device=cls_post.device)
        return torch.einsum("ch,c->h", cls_post, r).cpu().numpy()
