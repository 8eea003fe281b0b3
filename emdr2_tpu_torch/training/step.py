"""Optimizer, train state and the train step (port of
``emdr2_tpu/training/step.py``).

One step: forward (retriever scores + FiD reader + stop-gradient teacher)
-> joint loss -> backward -> global-norm clip -> AdamW on the fp32
parameters, with the AnnealingLR schedule. Compute runs in bf16 (the
layers' ``dtype``) with no loss scaling. Three details follow optax rather
than PyTorch's habits, so the port takes the JAX package's steps:

- the clip scales the gradients by ``max / norm`` only when ``norm >=
  max`` (``optax.clip_by_global_norm``), with no epsilon;
- the schedule is read at the update count before the update, so the first
  step's learning rate is ``schedule(0)``, 0 under warmup;
- parameters that got no gradient get a zero one, so AdamW still decays
  them and updates their moments, as optax does.

Weight decay skips biases, the LM bias and every LayerNorm (``decay_mask``,
the JAX package's rule on the same names). The state is updated in place:
the model's parameters and the optimizer's moments are PyTorch tensors.

Data parallelism (``dp``, a ``parallel.mesh.DataParallel``): each rank
runs the step on its slice of the global batch, with the losses' global
normalizers (``training/losses.py``), and ``Optimizer.step`` replaces the
gradients by their mean over the ranks *before* the clip, so the clip sees
the global norm and every rank applies the same update. The reduction is
an explicit all-reduce in fixed buckets in parameter order (no
``DistributedDataParallel`` hooks), the counterpart of the compiler's psum
in the JAX step; it leaves the remat layouts as they are.

Tensor parallelism (``dp.tp``): the ranks of one replica hold the parts of
its split parameters (``parallel/tensor.py``) and the same whole ones. The
gradient mean runs over the dp group only; the global norm sums the
squares of the split parameters' parts over tp and counts the whole
parameters once (their gradients are equal on the tp ranks), so every
rank clips by the same norm, the norm of the unsplit gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from emdr2_tpu_torch.config import EMDR2Config, OptimizerConfig
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold_seed
from emdr2_tpu_torch.parallel.mesh import DataParallel, Group
from emdr2_tpu_torch.parallel.tensor import is_split, split_of
from emdr2_tpu_torch.training.losses import emdr2_total_loss, scale_for_mean
from emdr2_tpu_torch.training.schedules import schedule_from_config
from emdr2_tpu_torch.utils.timing import StageTimer, stage


def _no_decay(name: str) -> bool:
    """True for parameters that are not weight-decayed: biases, the LM bias
    and LayerNorm parameters (every LayerNorm module is named ``ln_*``)."""
    parts = name.split(".")
    if parts[-1] in ("bias", "lm_bias"):
        return True
    return any(p.startswith("ln_") or p == "scale" for p in parts)


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where AdamW applies weight decay."""
    return {name: not _no_decay(name) for name, _ in model.named_parameters()}


def global_norm(tensors: List[torch.Tensor],
                split: Optional[List[bool]] = None,
                tp: Optional[Group] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``).
    Under ``tp``, ``split[i]`` marks the tensors that are this rank's part
    of a split one: their squares are summed over tp (one all-reduce), the
    others' counted once."""
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for t in tensors])
    if not is_split(tp):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(split, device=norms.device)
    sq = norms * norms
    parts = tp.all_reduce_sum_(torch.where(mask, sq, 0.0).sum()[None])[0]
    return torch.sqrt(parts + torch.where(mask, 0.0, sq).sum())


class Optimizer:
    """Global-norm clip -> AdamW (two parameter groups: decayed and not)
    with the learning rate of ``schedule`` at the update count. With a
    data-parallel group ``dp`` the gradients are first averaged over its
    ranks; under its ``dp.tp`` the norm is that of the unsplit gradient."""

    def __init__(self, model: EMDR2Model, cfg: OptimizerConfig,
                 schedule: Callable[[int], float],
                 dp: Optional[DataParallel] = None,
                 timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.schedule = schedule
        self.dp = dp
        self.timer = timer
        mask = decay_mask(model)
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.tp = dp.tp if dp is not None else None
        self.split = [split_of(n) is not None for n, _ in named]
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0,
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps)
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Average over the ranks (under ``dp``; the ``timer``'s
        ``grad_all_reduce`` span when they are more than one), clip,
        update, count; returns the global gradient norm (before the
        clip)."""
        if self.dp is not None and self.dp.distributed:
            with stage(self.timer, "grad_all_reduce"):
                self.dp.all_reduce_grads_(self.params)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads, self.split, self.tp)
        # optax: g -> (g / norm) * max when norm >= max; on the device,
        # with no host sync (g / 1 * 1 is g exactly)
        keep = norm < self.cfg.clip_grad
        one = torch.ones_like(norm)
        div = torch.where(keep, one, norm)
        mult = torch.where(keep, one, torch.full_like(norm,
                                                      self.cfg.clip_grad))
        for g in grads:
            g.div_(div).mul_(mult)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(model: EMDR2Model, cfg: OptimizerConfig,
                   total_iters: int,
                   dp: Optional[DataParallel] = None,
                   timer: Optional[StageTimer] = None) -> Optimizer:
    return Optimizer(model, cfg, schedule_from_config(cfg, total_iters), dp,
                     timer)


@dataclasses.dataclass
class TrainState:
    """The step count, the seed the dropout masks derive from, the model
    (fp32 parameters) and its optimizer."""

    step: int
    seed: int
    model: EMDR2Model
    optimizer: Optimizer

    def dropout_seeds(self, shard: int = 0, tp_shard: int = 0
                      ) -> DropoutSeeds:
        """This step's seeds: a pure function of (seed, step), on
        data-parallel rank ``shard`` and tensor-parallel rank
        ``tp_shard``."""
        return DropoutSeeds(fold_seed(self.seed, self.step), shard, tp_shard)


METRICS = ("loss", "lm_loss", "retriever_loss", "retriever_utility",
           "null_block_lm_loss", "grad_norm")


def _global_metrics(values: Dict[str, torch.Tensor],
                    dp: Optional[DataParallel]) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each metric summed over ``dp`` (one
    all-reduce); the values themselves in one process."""
    if dp is None or not dp.distributed:
        return values
    keys = list(values)
    total = dp.all_reduce_sum_(torch.stack([values[k].detach().float()
                                            for k in keys]))
    return {k: total[i] for i, k in enumerate(keys)}


def make_train_step(cfg: EMDR2Config, eos_id: int,
                    timer: Optional[StageTimer] = None,
                    dp: Optional[DataParallel] = None) -> Callable:
    """-> step_fn(state, batch) -> (state, metrics): forward with dropout
    -> loss -> backward -> (mean over ``dp``) -> clip -> AdamW, in place.
    Metrics are 0-d tensors on the model's device, those of the global
    batch under ``dp``. ``timer`` records these stages, on the card's
    events where the model lives on one, else on the host clock:

      forward_backward
        retriever_forward, reader_forward, teacher_forward
                           (``EMDR2Model.forward``)
        loss               (``emdr2_total_loss``)
        backward
      optimizer            (the mean over ``dp``, clip and AdamW)
        grad_all_reduce    (the mean over ``dp``, on more than one rank:
                           the optimizer's own timer, ``make_optimizer``'s
                           ``timer``)"""
    shard = dp.rank if dp is not None else 0
    tp = dp.tp if dp is not None else None
    tp_shard = tp.rank if tp is not None else 0

    def step_fn(state: TrainState, batch: EMDR2Batch):
        model = state.model
        with stage(timer, "forward_backward"):
            state.optimizer.zero_grad()
            out = model(batch, drop=state.dropout_seeds(shard, tp_shard),
                        timer=timer)
            with stage(timer, "loss"):
                total, aux = emdr2_total_loss(
                    out.lm_logits, out.topk_log_probs, out.gold_log_probs,
                    batch.labels, batch.loss_mask, eos_id=eos_id,
                    update_retriever=cfg.update_retriever,
                    use_kl_div=cfg.use_kl_div_loss, dp=dp, tp=tp)
            with stage(timer, "backward"):
                scale_for_mean(total, dp).backward()
        with stage(timer, "optimizer"):
            grad_norm = state.optimizer.step()
        state.step += 1
        metrics = _global_metrics(
            {"loss": total.detach(), "lm_loss": aux.lm_loss.detach(),
             "retriever_loss": aux.retriever_loss.detach(),
             "retriever_utility": aux.retriever_utility.detach(),
             "null_block_lm_loss": aux.null_block_lm_loss.detach()}, dp)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step_fn


def make_eval_forward(cfg: EMDR2Config, eos_id: int,
                      dp: Optional[DataParallel] = None) -> Callable:
    """-> eval_fn(state, batch) -> {"loss", "lm_loss", "retriever_loss"}:
    the step's forward and loss with no dropout and no gradient, of the
    global batch under ``dp``. Metrics are 0-d tensors on the model's
    device."""

    tp = dp.tp if dp is not None else None

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: EMDR2Batch):
        out = state.model(batch, drop=None)
        total, aux = emdr2_total_loss(
            out.lm_logits, out.topk_log_probs, out.gold_log_probs,
            batch.labels, batch.loss_mask, eos_id=eos_id,
            update_retriever=cfg.update_retriever,
            use_kl_div=cfg.use_kl_div_loss, dp=dp, tp=tp)
        return _global_metrics({"loss": total, "lm_loss": aux.lm_loss,
                                "retriever_loss": aux.retriever_loss}, dp)

    return eval_fn
