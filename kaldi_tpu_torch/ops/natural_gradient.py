"""Online natural-gradient (NG-SGD) preconditioning.

Port of kaldi_tpu/ops/natural_gradient.py (parity target: the
reference's OnlineNaturalGradient, src/nnet3/natural-gradient-online.h).
Per side of each 2-D parameter, a low-rank-plus-identity estimate of the
Fisher matrix F ≈ U diag(d) Uᵀ + ρ(I − U Uᵀ) is advanced by one step of
subspace iteration followed by Rayleigh–Ritz extraction, and update
directions are preconditioned by a smoothed inverse of F.

  * ``ng_init`` / ``ng_apply`` / ``ng_advance`` / ``ng_precondition``:
    the estimator as functions over ``NGState`` (its update count ``t``
    is a host integer, so nothing here waits on the card).
  * ``NgSgd``: the original's ``ngsgd`` optax chain (``scale_ng`` →
    ``optax.trace`` → learning rate) as a ``ScheduledOptimizer`` (a
    ``torch.optim.Optimizer`` with a step-count schedule and the
    trainer's per-tensor max-change clamp of the final update).  On the
    steps that advance the estimates (the first 10, then every
    ``update_period``-th), every side's small QR and eigh of the same
    shape go to one batched ``torch.linalg`` call each.

Gradients keep the torch layout (out, in); the estimator works on the
flax layout (in, out) the original sees, so the two agree exactly.

Over a model axis (``ScheduledOptimizer.shard``; parallel/tensor.py),
a sharded tensor's optimizer state is its slice (NG-SGD's momentum
trace, AdamW's moments), and the max-change clamp reads the whole
update's norm through one all-reduce of every sharded tensor's squared
norm a step.  NG-SGD's preconditioning and γ read the whole gradient:
it is gathered on every rank of the axis, the unchanged preconditioning
runs on the whole matrix (each rank holds the same NG estimates, rank 20
× dim a side), and each rank keeps its slice of the result.  The step
equals the unsharded one up to the order of the norm's sum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch


@dataclasses.dataclass
class NGState:
    U: torch.Tensor      # (D, R) orthonormal basis of the tracked subspace
    d: torch.Tensor      # (R,) eigenvalue estimates inside the subspace
    rho: torch.Tensor    # () eigenvalue estimate outside the subspace
    t: int = 0           # update count


def ng_init(dim: int, rank: int = 20, dtype=torch.float32,
            device: torch.device | str = "cpu") -> NGState:
    """Fresh estimator: U = I[:, :R], d = 0, ρ = 1e-10.  rank is clamped
    to dim − 1 like the reference's --rank-in/--rank-out defaults."""
    rank = max(1, min(rank, dim - 1)) if dim > 1 else 1
    return NGState(U=torch.eye(dim, rank, dtype=dtype, device=device),
                   d=torch.zeros(rank, dtype=dtype, device=device),
                   rho=torch.tensor(1e-10, dtype=dtype, device=device))


def ng_apply(state: NGState, X: torch.Tensor, alpha: float = 4.0,
             eps: float = 1e-10) -> torch.Tensor:
    """Rows of X (N×D) times (F + α·(tr F / D)·I)⁻¹: a linear map, no
    rescale."""
    D = X.shape[1]
    U, d, rho = state.U, state.d, state.rho
    R = U.shape[1]
    Xf = X.float()
    tr = d.sum() + rho * (D - R)
    s = alpha * torch.clamp(tr / D, min=eps)
    P = Xf @ U
    inv_in = 1.0 / (d + s)
    return ((Xf - P @ U.T) / (rho + s) + (P * inv_in) @ U.T).to(X.dtype)


def _advance_many(states: Sequence[NGState], Xs: Sequence[torch.Tensor],
                  num_samples_history: float = 2000.0,
                  eps: float = 1e-10) -> List[NGState]:
    """``ng_advance`` of each (state, X) pair, with the QRs of equal
    (D, R) and the eigh of equal R each in one batched call."""
    pre = []
    for st, X in zip(states, Xs):
        N, D = X.shape
        U, d = st.U, st.d
        R = U.shape[1]
        Xf = X.float()
        eta = 1.0 if st.t == 0 else 1.0 - math.exp(-N / num_samples_history)
        XU = Xf @ U
        CU = Xf.T @ XU / N
        Z = (1.0 - eta) * U * d[None, :] + eta * CU
        pre.append((Xf, eta, Z + eps * U))
    Qs = _batched(lambda z: torch.linalg.qr(z)[0], [p[2] for p in pre])
    Ms = []
    for st, (Xf, eta, _), Q in zip(states, pre, Qs):
        N = Xf.shape[0]
        U, d, rho = st.U, st.d, st.rho
        R = U.shape[1]
        A = U.T @ Q
        XQ = Xf @ Q
        M = ((1.0 - eta) * (A.T * d[None, :]) @ A
             + (1.0 - eta) * rho * (torch.eye(R, device=U.device) - A.T @ A)
             + eta * XQ.T @ XQ / N)
        Ms.append(0.5 * (M + M.T))
    eigs = _batched(torch.linalg.eigh, Ms)
    out = []
    for st, (Xf, eta, _), Q, (w, V) in zip(states, pre, Qs, eigs):
        N, D = Xf.shape
        R = st.U.shape[1]
        order = torch.argsort(-w, stable=True)
        w, V = w[order], V[:, order]
        tr = st.d.sum() + st.rho * (D - R)
        new_tr = (1.0 - eta) * tr + eta * torch.sum(Xf * Xf) / N
        new_d = torch.clamp(w, min=eps)
        new_rho = torch.clamp((new_tr - new_d.sum()) / max(D - R, 1),
                              min=eps)
        out.append(NGState(U=Q @ V, d=new_d, rho=new_rho, t=st.t + 1))
    return out


def _batched(fn: Callable, mats: Sequence[torch.Tensor]) -> list:
    """fn over each matrix, one call per group of equal shape (fn takes
    a stack and returns a tensor or a tuple of stacked tensors)."""
    groups: Dict[tuple, List[int]] = {}
    for i, m in enumerate(mats):
        groups.setdefault(tuple(m.shape), []).append(i)
    out: list = [None] * len(mats)
    for idx in groups.values():
        res = fn(torch.stack([mats[i] for i in idx]))
        for j, i in enumerate(idx):
            out[i] = (tuple(r[j] for r in res) if isinstance(res, tuple)
                      else res[j])
    return out


def ng_advance(state: NGState, X: torch.Tensor,
               num_samples_history: float = 2000.0,
               eps: float = 1e-10) -> NGState:
    """Advance the EMA covariance estimate with samples = rows of X: one
    step of subspace iteration on F' = (1−η) F + η XᵀX/N (η = 1 on the
    first call) and Rayleigh–Ritz extraction; the trace is preserved,
    the mass outside the subspace going to ρ."""
    return _advance_many([state], [X], num_samples_history, eps)[0]


def ng_precondition(state: NGState, X: torch.Tensor, alpha: float = 4.0,
                    num_samples_history: float = 2000.0,
                    eps: float = 1e-10):
    """(X̄, γ, new state): rows of X preconditioned by the smoothed
    inverse Fisher, γ with γ·‖X̄‖_F = ‖X‖_F, and the advanced estimate.
    A first call (t = 0) passes X through with γ = 1."""
    Xf = X.float()
    if state.t == 0:
        Xbar, gamma = Xf, torch.ones((), device=X.device)
    else:
        Xbar = ng_apply(state, Xf, alpha, eps)
        gamma = torch.sqrt(torch.clamp((Xf * Xf).sum(), min=1e-30)
                           / torch.clamp((Xbar * Xbar).sum(), min=1e-30))
    new_state = ng_advance(state, Xf, num_samples_history, eps)
    return Xbar.to(X.dtype), gamma.to(X.dtype), new_state


def clamp_update(u: torch.Tensor, max_change: float) -> torch.Tensor:
    """Kaldi's per-component max-change: u scaled so that ‖u‖₂ ≤
    max_change (0 disables)."""
    if max_change <= 0:
        return u
    n = torch.sqrt(torch.sum(u * u) + 1e-20)
    return u * torch.clamp(max_change / n, max=1.0)


Schedule = Union[float, Callable[[int], float]]


class ScheduledOptimizer(torch.optim.Optimizer):
    """An optimizer with optax's learning-rate schedule and the trainer's
    max-change: ``lr`` is a float or a schedule of the step count
    (``count``, 0 at the first step, kept in the state dict), and
    ``apply`` adds each tensor's final update clamped to l2 ≤
    max_change (0 disables)."""

    def __init__(self, params, defaults, lr: Schedule, max_change: float):
        super().__init__(params, defaults)
        self.schedule = lr
        self.max_change = max_change
        self.count = 0
        self.shards: Dict[torch.Tensor, object] = {}
        self.mesh = None

    def shard(self, shards: Dict[torch.Tensor, object], mesh) -> None:
        """Parameters that hold a slice of a tensor sharded over
        ``mesh``'s model axis, each with its parallel/tensor.py
        ``Shard``: their state is their slice's, and the clamp reads the
        whole update's norm."""
        self.shards, self.mesh = dict(shards), mesh

    def full_shape(self, p: torch.Tensor):
        sh = self.shards.get(p)
        return tuple(p.shape) if sh is None else sh.full_shape(p)

    def full(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``t`` (p's gradient, as p holds it) whole (a collective of the
        model axis when p is a shard)."""
        sh = self.shards.get(p)
        if sh is None:
            return t
        from kaldi_tpu_torch.parallel.tensor import gather_tensor
        return gather_tensor(t, sh, self.mesh)

    def local(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """p's slice of the whole tensor ``t``."""
        sh = self.shards.get(p)
        return t if sh is None else sh.take(t, self.mesh.model_index)

    def lr(self) -> float:
        return (self.schedule(self.count) if callable(self.schedule)
                else float(self.schedule))

    def apply(self, updates) -> None:
        """Add each (p, u) update (u shaped as p holds it) clamped to
        its whole tensor's l2 ≤ max_change: the sharded tensors' squared
        norms summed over the model axis in one all-reduce."""
        sharded = [(p, u) for p, u in updates if p in self.shards]
        for p, u in updates:
            if p not in self.shards:
                p.add_(clamp_update(u, self.max_change))
        if not sharded:
            return
        if self.max_change <= 0:
            for p, u in sharded:
                p.add_(u)
            return
        sq = self.mesh.all_reduce_model(torch.stack(
            [torch.sum(u * u) for _p, u in sharded]))
        scale = torch.clamp(self.max_change / torch.sqrt(sq + 1e-20),
                            max=1.0)
        for i, (p, u) in enumerate(sharded):
            p.add_(u * scale[i])

    def state_dict(self):
        """The state in the unsharded layout: a sharded tensor's slices
        of state gathered whole (a collective of the model axis)."""
        sd = super().state_dict()
        sd["count"] = self.count
        if self.shards:
            from kaldi_tpu_torch.parallel.tensor import gather_tensor
            params = [p for g in self.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                sh = self.shards.get(p)
                if sh is None or i not in sd["state"]:
                    continue
                sd["state"][i] = {
                    k: (gather_tensor(v, sh, self.mesh)
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in sd["state"][i].items()}
        return sd

    def load_state_dict(self, state_dict):
        """Load a state in the unsharded layout (this rank's slices of
        it on a model axis)."""
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        for p, sh in self.shards.items():
            st = self.state.get(p, {})
            full = sh.full_shape(p)
            for k, v in st.items():
                if torch.is_tensor(v) and tuple(v.shape) == full:
                    st[k] = self.local(p, v)

    def state_bytes(self, whole: bool = False) -> int:
        """Bytes of the optimizer state this rank holds, or with
        ``whole`` of the unsharded model's (``state_dict``'s: a
        collective of the model axis)."""
        def size(v):
            if torch.is_tensor(v):
                return v.numel() * v.element_size()
            if isinstance(v, dict):
                return sum(size(x) for x in v.values())
            return 0
        return size(self.state_dict()["state"] if whole else self.state)


class NgSgd(ScheduledOptimizer):
    """NG-SGD: two-sided natural-gradient preconditioning of every 2-D
    gradient, scaled by one γ that keeps ‖G‖_F, then momentum
    (t ← g + μ·t), then −lr, then the max-change clamp of the update,
    which is then added to the parameter.  1-D parameters skip the
    preconditioning.  ``lr`` is a float or a schedule of the step count
    (0 at the first step)."""

    def __init__(self, params, lr: Schedule, momentum: Optional[float] = None,
                 rank_in: int = 20, rank_out: int = 20, alpha: float = 4.0,
                 num_samples_history: float = 2000.0, update_period: int = 4,
                 max_change: float = 0.0):
        super().__init__(params, dict(momentum=momentum or 0.0), lr,
                         max_change)
        self.rank_in, self.rank_out = rank_in, rank_out
        self.alpha = alpha
        self.num_samples_history = num_samples_history
        self.update_period = update_period

    def _states(self, p):
        st = self.state[p]
        if "trace" not in st:
            st["trace"] = torch.zeros_like(p)
            if p.dim() == 2:
                out_dim, in_dim = self.full_shape(p)
                # the flax layout (in, out): rows of G are samples of
                # dim out for the "in" side, columns of dim in for "out"
                st["ng_in"] = vars(ng_init(out_dim, self.rank_in,
                                           device=p.device))
                st["ng_out"] = vars(ng_init(in_dim, self.rank_out,
                                            device=p.device))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        # the reference updates the estimates on every one of the first
        # 10 steps, then every update_period-th
        advance = self.count < 10 or self.count % self.update_period == 0
        lr = self.lr()
        adv_states, adv_x, adv_keys, updates = [], [], [], []
        for group in self.param_groups:
            mu = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._states(p)
                g = self.full(p, p.grad).float()
                if p.dim() == 2:
                    gf = g.T
                    s_in = NGState(**st["ng_in"])
                    s_out = NGState(**st["ng_out"])
                    if s_in.t == 0:
                        u = g
                    else:
                        gbar = ng_apply(s_out, ng_apply(s_in, gf, self.alpha)
                                        .T, self.alpha).T
                        gamma = torch.sqrt(
                            torch.clamp((gf * gf).sum(), min=1e-30)
                            / torch.clamp((gbar * gbar).sum(), min=1e-30))
                        u = (gamma * gbar).T
                    if advance:
                        adv_states += [s_in, s_out]
                        adv_x += [gf, gf.T]
                        adv_keys += [(st, "ng_in"), (st, "ng_out")]
                else:
                    u = g
                u = self.local(p, u)
                tr = st["trace"]
                if mu:
                    tr.mul_(mu).add_(u)
                    u = tr
                updates.append((p, -lr * u))
        self.apply(updates)
        if adv_states:
            new = _advance_many(adv_states, adv_x, self.num_samples_history)
            for (st, key), s in zip(adv_keys, new):
                st[key] = vars(s)
        self.count += 1
        return loss
