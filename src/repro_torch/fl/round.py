"""The FedFog LM round, the paper's Fig. 1 dataflow at model scale (port
of ``repro/fl/round.py``).

    schedule (Eqs. 1/2/3/7/10, over the N-client registry)
      └─ slot occupancy: top-C eligible clients by utility
    local training (Eq. 5): C slots × E local steps, a fresh inner
      optimizer per slot (serverless, stateless semantics)
    deltas: clip (DP sensitivity) → attacks (eval) → compression
    aggregate (Eq. 6) → server update: FedAvg / FedAvgM / FedAdam
    bookkeeping: cold starts (Eq. 4), energy (Eq. 10 + §IV.F), drift

``make_round_fn`` returns ``round_fn(state, batch) -> (state, metrics)``.

Memory. The JAX round broadcasts the parameters to C replicas and vmaps
local training over them; at llama3.2-1b's width that and the fused
buffer would not fit one 80 GB card. Here the slots train one after
another, each from the round's parameters with a fresh inner optimizer,
exactly as one lane of the vmap, and each writes its delta (rounded to
the parameter dtype, then widened, as the JAX round's deltas are) into
row c of ONE preallocated (C, P) float32 buffer: no stacked delta tree
and no concatenated copy. The kernel path hands that buffer to K3 (or to
K4 per fog) with the parameters flattened once; the server momentum is
kept as views of one (P,) buffer, which goes to the kernel uncopied.
Operations the JAX round applies to the delta TREE (the reference
pipeline, the attacks' clip and corruption on the kernel path, fault
corruption) run on per-leaf views of the buffer in the parameter dtype
and are written back when the kernel path follows.

Randomness. Every draw comes from the provider (``repro_torch.random``)
keyed by the round index ``state.step``, a host integer: ``rcs.perm``,
``slots.malicious``, ``attack``, ``dp``, ``cohort`` and ``faults.*``. The
default configuration (FedFog policy, no attack, no DP, dense, no
faults) draws nothing.

The round reads nothing back from the device: no ``.item()``, no host
copy; Python constants on the card are fills (``device.scalar``).

Under mesh rules (``rules``, ``dist.sharding.ShardingRules`` of this
rank's ``dist.meshes.Mesh``) the round runs on every rank of a
``torch.distributed`` world, the JAX package's client-sharded round:

  * the scheduler, telemetry, draws and fault plan run replicated on
    every rank from the same draws (the JAX round's replicated island);
    slot-indexed arrays are sliced to the rank's rows;
  * the rank trains only its ``C / client_ways`` slots
    (``rules.slot_range``) into a (C_local, P) buffer, one after another;
    along the ``zero`` axis it takes its share of each step's batch
    (``rules.batch_range``) and the slot's gradient is averaged with ONE
    all-reduce over the zero group a local step (never crossing clients);
    the parameters stay replicated;
  * the server pass is ``delta_pipeline_apply_sharded`` (K4 on the rank's
    rows, one packed all-reduce over the client group, per tier with a
    fog tier) when ``use_pallas_agg``; otherwise the plain per-rank
    partial sum takes the same single packed all-reduce;
  * the loss is reduced with a scalar-sized all-reduce over the world
    (over the data axes on a plan with a model split: once per slot).

Without a model split the state stays replicated: every rank computes
the same new state. With one (``tp`` / ``sp`` on the DENSE family,
``dist.tensor_parallel``) each rank holds its blocks of the parameters
and the server momentum (``ShardingRules.tensor_specs``) and trains on
them through the tensor-parallel layer (``Runtime.tensor``); its slot's
delta is its (C_local, P_local) columns. The server pass keeps the JAX
round's ``shard_p=False`` layout: the delta rows, the base and the
momentum are gathered over the model group into whole (C_local, P)
rows in the single-process layout (phase ``gather``), the pass above
runs on them unchanged (K3 when the client axes span one rank), and
the rank keeps its blocks of the new parameters and momentum. Median /
trimmed and the attacks need every client's rows on one rank and raise
under rules (ROADMAP.md item 11(b), step 5).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import tree
from repro_torch.core import aggregation as agg_mod
from repro_torch.core import privacy as privacy_mod
from repro_torch.core.scheduler import account_energy, schedule_round
from repro_torch.core.selection import random_selection_mask
from repro_torch.core.types import ClientTelemetry, SchedulerWeights, static_on
from repro_torch.device import scalar
from repro_torch.dist.collectives import labelled
from repro_torch.dist.tensor_parallel import TensorParallel
from repro_torch.fl import attacks as attacks_mod
from repro_torch.fl import fog as fog_mod
from repro_torch.fl.compression import apply_compression, wire_bytes_per_param
from repro_torch.fl.fuse import fused_gaussian_noise
from repro_torch.fl.state import FLConfig, FLState
from repro_torch.kernels.delta_pipeline import sharded as sharded_mod
from repro_torch.models.transformer import Runtime
from repro_torch.obs.ranges import profiler_range
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm, sgdm
from repro_torch.random import TorchDraws, split_key
from repro_torch.sim.des import RoundCostModel
from repro_torch.sim.faults import config as faults_config
from repro_torch.sim.faults import inject as faults_inject

_NOT_UNDER_RULES = ("under mesh rules is not ported yet (it needs every client's rows "
                    "on one rank): ROADMAP.md queue 1, item 11(b), step 5")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    kind: str = "none"  # none|label_flip|noise|dropout|model_replacement
    fraction: float = 0.0  # fraction of malicious slots
    noise_scale: float = 0.5
    replacement_scale: float = 10.0


@contextlib.contextmanager
def _phase(name: str):
    """The ``train.<name>`` profiler range of a phase of the round; the
    collectives made in it carry ``name`` (``dist.collectives``)."""
    with profiler_range(f"train.{name}"), labelled(name):
        yield


def _inner_optimizer(fl_cfg: FLConfig):
    if fl_cfg.inner_optimizer == "adamw":
        return adamw(fl_cfg.inner_lr)
    return sgdm(fl_cfg.inner_lr, fl_cfg.inner_momentum)


def _slot_assignment(decision, fl_cfg: FLConfig, draws, round_idx: int):
    """Top-C eligible clients by utility -> (slot_client_ids, slot_mask).

    Policies (§IV.B): fedfog = utility-ranked eligible; rcs = uniform
    random (the ``rcs.perm`` draw); fogfaas / vanilla = the first C
    clients, no gating."""
    n, c = fl_cfg.num_clients, fl_cfg.slots
    sel = decision.selection
    if fl_cfg.policy == "fedfog":
        # (eligible desc, utility desc): eligible clients first
        key_val = sel.utility - 1e6 * (~sel.mask)
        slot_ids = torch.argsort(-key_val, stable=True)[:c]
        slot_mask = sel.mask[slot_ids]
    elif fl_cfg.policy == "rcs":
        rmask = random_selection_mask(
            draws.permutation("rcs.perm", n, round=round_idx), c)
        slot_ids = torch.argsort(-rmask.to(torch.int32), stable=True)[:c]
        slot_mask = rmask[slot_ids]
    else:
        dev = sel.mask.device
        slot_ids = torch.arange(c, dtype=torch.int64, device=dev)
        slot_mask = torch.ones((c,), dtype=torch.bool, device=dev)
    return slot_ids, slot_mask


class _Layout:
    """Leaf order, shapes, dtypes and column offsets of a parameter tree in
    the fused (P,) / (C, P) layout (``tree.leaves`` order, the JAX
    package's flatten order)."""

    @classmethod
    def of_decls(cls, decls):
        """The layout of a ``ParamDecl`` tree (shape-only leaves)."""
        return cls(tree.map(lambda d: torch.empty(d.shape, dtype=getattr(torch, d.dtype),
                                                  device="meta"), decls))

    def __init__(self, params):
        self.like = params
        flat = tree.leaves(params)
        self.shapes = [tuple(x.shape) for x in flat]
        self.dtypes = [x.dtype for x in flat]
        self.sizes = tuple(x.numel() for x in flat)
        self.offsets = [sum(self.sizes[:i]) for i in range(len(flat))]
        self.p = sum(self.sizes)

    def spans(self):
        return zip(self.offsets, self.sizes, self.shapes, self.dtypes)

    def flatten(self, t, device) -> torch.Tensor:
        """``t`` as one (P,) float32 vector: its leaves' own buffer when they
        are consecutive float32 views of one (the server momentum after a
        kernel round), else a copy."""
        flat = tree.leaves(t)
        base = flat[0]._base
        if (base is not None and base.dim() == 1 and base.dtype == torch.float32
                and base.numel() == self.p and base.is_contiguous()
                and all(x._base is base and x.is_contiguous()
                        and x.data_ptr() == base.data_ptr() + 4 * off
                        for x, off in zip(flat, self.offsets))):
            return base
        out = torch.empty((self.p,), dtype=torch.float32, device=device)
        for x, (off, n, _, _) in zip(flat, self.spans()):
            out[off:off + n].copy_(x.reshape(-1))
        return out

    def unflatten(self, vec: torch.Tensor):
        """A (P,) vector -> the tree, each leaf cast to its dtype (a view
        for float32 leaves)."""
        return tree.unflatten(self.like, [
            vec[off:off + n].view(shape).to(dt) for off, n, shape, dt in self.spans()])

    def rows(self, buf: torch.Tensor):
        """The (C, P) buffer as a (C, ...)-stacked tree in the parameter
        dtypes."""
        c = buf.shape[0]
        return tree.unflatten(self.like, [
            buf[:, off:off + n].reshape((c,) + shape).to(dt)
            for off, n, shape, dt in self.spans()])

    def write_rows(self, buf: torch.Tensor, stacked) -> None:
        """Write a (C, ...)-stacked tree back into the (C, P) buffer (a
        leaf that is still the buffer's own view, as ``rows`` gives a
        float32 leaf no stage changed, is already there)."""
        c = buf.shape[0]
        for x, (off, n, _, _) in zip(tree.leaves(stacked), self.spans()):
            dst = buf[:, off:off + n]
            if x.data_ptr() != dst.data_ptr() or x.dtype != dst.dtype:
                dst.copy_(x.reshape(c, n))


def _value_and_grad(loss_fn, params, batch):
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, list(grads))


def make_round_fn(
    model,
    fl_cfg: FLConfig,
    runtime: Runtime = Runtime(),
    attack: AttackConfig = AttackConfig(),
    *,
    flops_per_client_round: float | None = None,
    rules=None,
    draws=None,
):
    """Build the FedFog round.

    batch dict (leading dims slot-major), tensors on the state's device:
      tokens:          (global_batch, S+1) int  [viewed as (C, B_c, S+1)]
      slot_data_sizes: (C,) f32 — |D_i| of each slot occupant
      telemetry_cpu/mem/batt/energy: (N,) f32
      hist:            (N, hist_bins) f32

    ``draws`` is the draw provider; by default a ``TorchDraws`` of seed 0
    on the state's device."""
    c = fl_cfg.slots
    lo, hi = 0, c  # the slots this rank trains
    tp = None  # this rank's tensor-parallel view (a plan with a model split)
    if rules is not None:
        if fl_cfg.aggregator != "fedavg":
            raise NotImplementedError(f"aggregator {fl_cfg.aggregator!r} {_NOT_UNDER_RULES}")
        if attack.kind != "none":
            raise NotImplementedError(f"attack {attack.kind!r} {_NOT_UNDER_RULES}")
        lo, hi = rules.slot_range(c)
        tp = TensorParallel.from_rules(rules)
        if tp is not None:
            runtime = dataclasses.replace(runtime, tensor=tp)
        if fl_cfg.fog_nodes > 1 and rules.client_ways > 1:
            sharded_mod.split_fog_axes(rules.mesh, rules.plan.client_axes, fl_cfg.fog_nodes)
    zero = rules.zero_ways if rules is not None else 1
    init_inner, update_inner = _inner_optimizer(fl_cfg)
    flops_round = flops_per_client_round or 0.0
    # §IV.F cost accounting shared with the paper-scale simulator
    cost_model = RoundCostModel.from_scheduler(fl_cfg.scheduler)
    use_kernel = fl_cfg.use_pallas_agg
    pop_mode = (fl_cfg.population is not None
                and fl_cfg.population != fl_cfg.num_clients)
    faults_on = faults_config.active(fl_cfg.faults)
    per_device: dict = {}

    def constants(dev):
        """The provider and the scheduler's α / β on ``dev``, built once and
        by fills (no host copy)."""
        if dev not in per_device:
            sc = fl_cfg.scheduler
            vec = lambda xs: torch.stack([scalar(x, dev) for x in xs])  # noqa: E731
            per_device[dev] = (
                draws if draws is not None else TorchDraws(0, dev),
                SchedulerWeights(alpha=vec(sc.alpha), beta=vec(sc.beta)),
            )
        return per_device[dev]

    def per_slot_loss(params_c, batch_c):
        return model.loss(params_c, batch_c, runtime)

    def grad_fn(params_s, batch_s):
        """(losses, grads) of one slot's step batch: a single (loss,)
        with grads in the parameter dtype, or with ``microbatch`` splits
        their losses and the float32 mean of their grads."""
        mb = fl_cfg.microbatch
        if mb <= 1:
            loss, grads = _value_and_grad(per_slot_loss, params_s, batch_s)
            return [loss], grads
        rows = next(iter(batch_s.values())).shape[0] // mb
        g_acc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params_s)
        losses = []
        for m in range(mb):
            micro = {k: v[m * rows:(m + 1) * rows] for k, v in batch_s.items()}
            loss, g = _value_and_grad(per_slot_loss, params_s, micro)
            g_acc = tree.map(lambda a, b: a + b.to(torch.float32), g_acc, g)
            losses.append(loss)
        return losses, tree.map(lambda a: a / mb, g_acc)

    def zero_mean(grads, layout, dev):
        """The slot's gradient averaged over its zero shares: ONE float32
        all-reduce over the zero group (equal shares, so the mean of the
        shares' mean-loss gradients is the whole batch's)."""
        flat = layout.flatten(grads, dev)
        torch.distributed.all_reduce(flat, group=rules.mesh.group(("zero",)))
        return layout.unflatten(flat.div_(zero))

    def local_training(params0, model_batch, layout, dev):
        """This rank's slots' E local steps, one slot after another, each
        delta written into its row of the (C_local, P) float32 buffer.
        Returns the buffer and the JAX round's ``mean_loss`` (the last
        step's loss, averaged over slots, and over microbatches in the
        JAX order; under rules averaged over every rank's slots and zero
        shares with one scalar-sized all-reduce)."""
        e = fl_cfg.local_steps
        buf = torch.empty((hi - lo, layout.p), dtype=torch.float32, device=dev)
        last = []  # [slot][microbatch] losses of the last step
        for s in range(hi - lo):
            params_s = params0
            inner = init_inner(params0)
            for step in range(e):
                batch_s = {}
                for k, v in model_batch.items():
                    rows = v.shape[1] // e
                    b_lo, b_hi = (rules.batch_range(rows) if rules is not None
                                  else (0, rows))
                    batch_s[k] = v[s, step * rows + b_lo:step * rows + b_hi]
                losses, grads = grad_fn(params_s, batch_s)
                if zero > 1:
                    grads = zero_mean(grads, layout, dev)
                updates, inner = update_inner(grads, inner, params_s)
                params_s = apply_updates(params_s, updates)
                del grads, updates
            last.append(losses)
            for p, p0, (off, n, _, _) in zip(tree.leaves(params_s),
                                            tree.leaves(params0), layout.spans()):
                d = (p.to(torch.float32) - p0.to(torch.float32)).to(p.dtype)
                buf[s, off:off + n].copy_(d.reshape(-1))
            del params_s, inner
        if rules is not None:
            # Σ over every rank's slots and zero shares, per microbatch
            per_mb = torch.sum(torch.stack([torch.stack(ls) for ls in last]), dim=0)
            if tp is None:
                torch.distributed.all_reduce(per_mb)
            elif rules.mesh.ways(rules.plan.data_axes) > 1:  # each slot once
                torch.distributed.all_reduce(per_mb,
                                             group=rules.mesh.group(rules.plan.data_axes))
            per_mb = per_mb / (c * zero)
            mean_loss = per_mb[0] if fl_cfg.microbatch <= 1 else (
                torch.sum(per_mb) / fl_cfg.microbatch)
        elif fl_cfg.microbatch <= 1:
            mean_loss = torch.mean(torch.stack([ls[0] for ls in last]))
        else:
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for m in range(fl_cfg.microbatch):
                acc = acc + torch.mean(torch.stack([ls[m] for ls in last]))
            mean_loss = acc / fl_cfg.microbatch
        return buf, mean_loss

    def round_fn(state: FLState, batch) -> tuple[FLState, dict]:
        r = int(state.step)
        dev = batch["hist"].device
        rd, weights = constants(dev)

        # ---- 1. schedule over the N-client registry (Eqs. 1/2/3/7) ----- #
        with _phase("schedule"):
            telemetry = ClientTelemetry(
                cpu=batch["telemetry_cpu"], mem=batch["telemetry_mem"],
                batt=batch["telemetry_batt"], energy=batch["telemetry_energy"],
            )
            window_ids = None
            sched_view = state.sched
            if pop_mode:
                # the round's window of the (M,) registry; the batch's telemetry
                # and histogram rows are window-positional
                window_ids = fog_mod.stratified_cohort(
                    rd, fl_cfg.population, fl_cfg.num_clients, round=r)
                sched_view = fog_mod.gather_sched_rows(state.sched, window_ids)
            decision = schedule_round(sched_view, telemetry, batch["hist"],
                                      fl_cfg.scheduler, weights)
            slot_ids, slot_mask = _slot_assignment(decision, fl_cfg, rd, r)
            slot_sizes = batch["slot_data_sizes"]

        # ---- 2. local training: C slots × E local steps --------------- #
        with _phase("local_training"):
            model_batch = {
                k: v.reshape((c, v.shape[0] // c) + tuple(v.shape[1:]))[lo:hi]
                for k, v in batch.items() if k in ("tokens", "patch_embeds", "frames")
            }
            malicious = torch.zeros((c,), dtype=torch.bool, device=dev)
            if attack.kind != "none":
                n_mal = int(round(attack.fraction * c))
                perm = rd.permutation("slots.malicious", c, round=r)
                malicious = (torch.arange(c, device=dev) < n_mal)[perm]
            if attack.kind == "label_flip":
                model_batch["tokens"] = attacks_mod.flip_labels(
                    model_batch["tokens"], malicious, model.cfg.vocab_size)

            params0 = state.params
            layout = _Layout(params0)
            buf, mean_loss = local_training(params0, model_batch, layout, dev)

        # the model group's blocks -> whole rows, base and momentum (JAX
        # shard_p=False: P whole within a client shard)
        mu_on = (fl_cfg.server_optimizer in ("fedavgm", "fedadam")
                 and state.server_mu is not None)
        base_flat = mu_flat = None
        if tp is not None:
            with _phase("gather"):
                buf = tp.gather_rows(buf)
                base_flat = tp.gather_flat(params0)
                mu_flat = tp.gather_flat(state.server_mu) if mu_on else None
                layout = _Layout.of_decls(tp.decls)

        # ---- 3. deltas: clip → attack → compress ----------------------- #
        # Delta attacks land BETWEEN clip and compress, so on the kernel
        # path those two stages run here and the kernel runs unclipped.
        with _phase("deltas"):
            split_clip = use_kernel and attack.kind not in ("none", "label_flip")
            deltas = None  # a modified delta tree, when a stage ran on one
            if not use_kernel or split_clip:
                deltas = layout.rows(buf)
                if fl_cfg.clip_norm > 0:
                    deltas, _ = clip_by_global_norm(deltas, fl_cfg.clip_norm,
                                                    per_client=True)
                if attack.kind not in ("none", "label_flip"):
                    deltas = attacks_mod.corrupt_deltas(
                        deltas, malicious, attack.kind, rd, round=r,
                        noise_scale=attack.noise_scale,
                        replacement_scale=attack.replacement_scale,
                    )
                    slot_mask = attacks_mod.dropout_mask(slot_mask, malicious, attack.kind)
                if not use_kernel:
                    deltas = apply_compression(deltas, fl_cfg.compression,
                                               fl_cfg.topk_fraction)

            # ---- 3b. fault plan: who actually arrives (sim.faults) --------- #
            fault_counters = faults_inject.zero_counters(dev)
            fault_skip = fault_round_ms = plan = None
            if faults_on:
                fc = fl_cfg.faults
                plan = faults_inject.plan_round(
                    fc, rd, slot_mask, ~sched_view.warm[slot_ids],
                    decision.delays_ms[slot_ids], fog_nodes=fl_cfg.fog_nodes, round=r,
                )
                if static_on(fc.corrupt_rate):  # else no payload is corrupted
                    deltas = attacks_mod.corrupt_deltas(
                        layout.rows(buf) if deltas is None else deltas, plan.corrupt,
                        "noise", rd, round=r, site="faults.noise",
                        noise_scale=fc.corrupt_scale, rows=slice(lo, hi),
                    )
                slot_mask = plan.arrived  # Eq. 6 reweights over the arrivals
                fault_counters = plan.counters
                fault_skip, fault_round_ms = plan.skip, plan.round_ms

        # ---- 4+5. aggregate (Eq. 6) + server update -------------------- #
        with _phase("server"):
            if rules is not None:
                if tp is None:
                    base_flat = layout.flatten(params0, dev)
                    mu_flat = layout.flatten(state.server_mu, dev) if mu_on else None
                new_flat, new_mu_flat = _sharded_server(
                    fl_cfg, rules, layout, buf, deltas, base_flat, mu_flat,
                    slot_mask[lo:hi], slot_sizes[lo:hi], rd, r)
                del buf, deltas, base_flat, mu_flat
                new_mu = state.server_mu
                if tp is not None:  # this rank's blocks of the new state
                    new_params = tp.shard_flat(new_flat, params0)
                    if new_mu_flat is not None:
                        new_mu = tp.shard_flat(new_mu_flat, state.server_mu, flat=True)
                else:
                    new_params = layout.unflatten(new_flat)
                    if new_mu_flat is not None:
                        new_mu = tree.unflatten(state.server_mu, [
                            new_mu_flat[off:off + n].view(shape)
                            for off, n, shape, _ in layout.spans()])
                del new_flat, new_mu_flat
                new_count = state.server_count + 1
            elif use_kernel:
                if deltas is not None:
                    layout.write_rows(buf, deltas)
                    del deltas
                base_flat = layout.flatten(params0, dev)
                seg = layout.sizes
                noise = None
                if fl_cfg.dp_sigma > 0:
                    noise = fused_gaussian_noise(
                        rd, fl_cfg.dp_sigma * (fl_cfg.clip_norm or 1.0), seg, round=r)
                mu_flat = None
                if (fl_cfg.server_optimizer in ("fedavgm", "fedadam")
                        and state.server_mu is not None):
                    mu_flat = layout.flatten(state.server_mu, dev)
                kw = dict(
                    lr=fl_cfg.server_lr, dp_noise=noise, momentum=mu_flat,
                    clip_norm=0.0 if split_clip else fl_cfg.clip_norm,
                    compression=fl_cfg.compression, topk_fraction=fl_cfg.topk_fraction,
                    seg_sizes=seg, server_optimizer=fl_cfg.server_optimizer,
                    server_momentum=fl_cfg.server_momentum,
                )
                if fl_cfg.fog_nodes > 1:
                    outs = fog_mod.fog_pipeline_apply(
                        buf, base_flat, slot_mask, slot_sizes,
                        fog_nodes=fl_cfg.fog_nodes, **kw)
                else:
                    from repro_torch.kernels.delta_pipeline import ops as dp_ops

                    outs = dp_ops.delta_pipeline_apply(
                        buf, base_flat, slot_mask, slot_sizes,
                        trim_fraction=fl_cfg.trim_fraction, aggregator=fl_cfg.aggregator,
                        **kw)
                del buf, base_flat, noise
                if mu_flat is not None:
                    new_flat, new_mu_flat = outs
                    new_mu = tree.unflatten(state.server_mu, [
                        new_mu_flat[off:off + n].view(shape)
                        for off, n, shape, _ in layout.spans()])
                else:
                    new_flat, new_mu = outs, state.server_mu
                new_params = layout.unflatten(new_flat)
                new_count = state.server_count + 1
            else:
                if fl_cfg.aggregator == "median":
                    agg = agg_mod.median_aggregate(deltas, slot_mask)
                elif fl_cfg.aggregator == "trimmed":
                    agg = agg_mod.trimmed_mean_aggregate(deltas, slot_mask,
                                                         fl_cfg.trim_fraction)
                elif fl_cfg.fog_nodes > 1:
                    # hierarchical Eq. 6: fog partials -> cloud combine
                    agg = fog_mod.fog_aggregate_tree(deltas, slot_mask, slot_sizes,
                                                     fl_cfg.fog_nodes)
                else:
                    agg = agg_mod.fedavg_stacked(deltas, slot_mask, slot_sizes)
                del buf, deltas
                if fl_cfg.dp_sigma > 0:
                    dp = privacy_mod.DPConfig(sigma=fl_cfg.dp_sigma,
                                              sensitivity=fl_cfg.clip_norm or 1.0)
                    agg = privacy_mod.gaussian_mechanism(agg, rd, dp, round=r)
                new_params, new_mu, new_count = _server_update(
                    fl_cfg, params0, agg, state.server_mu, state.server_count)

            if fault_skip is not None:
                # below quorum the model and the server optimizer state carry
                # over bitwise: the attempted aggregate is discarded
                keep = lambda p, q: torch.where(fault_skip, p, q)  # noqa: E731
                new_params = tree.map(keep, params0, new_params)
                if state.server_mu is not None:
                    new_mu = tree.map(keep, state.server_mu, new_mu)
                new_count = torch.where(fault_skip, state.server_count, new_count)

        # ---- 6. energy / cold-start / drift bookkeeping ---------------- #
        # per-LOGICAL-client energy: compute ∝ FLOPs for selected clients,
        # uplink ∝ compressed delta bytes (§IV.F)
        with _phase("bookkeeping"):
            tx_bytes = wire_bytes_per_param(
                fl_cfg.compression, fl_cfg.topk_fraction) * float(model.param_count())
            round_energy_j = cost_model.energy_j(
                decision.selection.mask, sched_view.warm, flops_round, tx_bytes)
            if faults_on:
                # every launched attempt repays the slot's full energy
                round_energy_j = round_energy_j * torch.ones_like(round_energy_j).index_copy(
                    0, slot_ids, torch.clamp(plan.attempts, min=1.0))
            advanced = account_energy(decision.new_state, round_energy_j, fl_cfg.scheduler)
            new_sched = (fog_mod.scatter_sched_rows(state.sched, window_ids, advanced)
                         if pop_mode else advanced)

        new_state = FLState(
            params=new_params, server_mu=new_mu, server_count=new_count,
            sched=new_sched, rng=split_key(state.rng, 5)[0], step=r + 1,
        )
        metrics = {
            "loss": mean_loss,
            "num_selected": decision.selection.num_selected,
            "slot_participation": torch.sum(slot_mask.to(torch.int32)),
            "cold_starts": decision.cold_starts,
            # synchronous round latency = slowest selected client (§III.H);
            # under faults the retry / backoff chain (deadline-capped)
            "round_latency_ms": (
                fault_round_ms if fault_round_ms is not None
                else torch.max(torch.where(slot_mask, decision.delays_ms[slot_ids],
                                           0.0))
            ),
            "energy_j": torch.sum(round_energy_j),
            "mean_utility": torch.mean(decision.selection.utility),
            "mean_drift": torch.mean(decision.selection.drift),
            **fault_counters,
        }
        return new_state, metrics

    return round_fn


def _sharded_server(fl_cfg: FLConfig, rules, layout, buf, deltas, base_flat, mu_flat,
                    mask, sizes, rd, r: int):
    """The server pass under rules on this rank's (C_local, P) rows, the
    fused (P,) base and momentum (None: no momentum):
    ``delta_pipeline_apply_sharded`` (K4, one packed all-reduce per tier;
    K3 when the client axes span one rank) with ``use_pallas_agg``, else
    the plain partial sum of the transformed ``deltas`` through the same
    packed all-reduce and epilogue. Returns the fused (new params, new
    server momentum or None)."""
    seg = layout.sizes
    noise = None
    if fl_cfg.dp_sigma > 0:
        noise = fused_gaussian_noise(
            rd, fl_cfg.dp_sigma * (fl_cfg.clip_norm or 1.0), seg, round=r)
    if deltas is not None:
        layout.write_rows(buf, deltas)
    epi = dict(dp_noise=noise, momentum=mu_flat, server_optimizer=fl_cfg.server_optimizer,
               server_momentum=fl_cfg.server_momentum)
    where = dict(mesh=rules.mesh, client_axes=rules.plan.client_axes,
                 fog_nodes=fl_cfg.fog_nodes)
    if fl_cfg.use_pallas_agg:
        outs = sharded_mod.delta_pipeline_apply_sharded(
            buf, base_flat, mask, sizes, fl_cfg.server_lr, **epi, **where,
            clip_norm=fl_cfg.clip_norm, compression=fl_cfg.compression,
            topk_fraction=fl_cfg.topk_fraction, seg_sizes=seg)
        new_flat, new_mu_flat = outs if mu_flat is not None else (outs, None)
    else:
        dm, m = fog_mod.discounted_weights(mask, sizes, None, 0.0)
        packed = sharded_mod.packed_partials(
            dm, m, layout.p, lambda out: torch.mv(buf.t(), dm, out=out))
        new_flat, new_mu_flat = sharded_mod.reduce_and_combine(
            packed, base_flat, fl_cfg.server_lr, **epi, **where)
    return new_flat, new_mu_flat


def _server_update(fl_cfg: FLConfig, params0, agg, mu, count):
    lr = fl_cfg.server_lr
    count = count + 1
    f32 = torch.float32
    if fl_cfg.server_optimizer == "fedavg" or mu is None:
        new_params = tree.map(
            lambda p, a: (p.to(f32) + lr * a.to(f32)).to(p.dtype), params0, agg)
        return new_params, mu, count
    m = fl_cfg.server_momentum
    new_mu = tree.map(lambda mu_l, a: m * mu_l + a.to(f32), mu, agg)
    if fl_cfg.server_optimizer == "fedadam":
        # Adam-style with a fixed epsilon on the aggregated delta magnitude
        new_params = tree.map(
            lambda p, mu_l, a: (
                p.to(f32) + lr * mu_l / (torch.sqrt(torch.square(a.to(f32))) + 1e-3)
            ).to(p.dtype),
            params0, new_mu, agg,
        )
    else:  # fedavgm
        new_params = tree.map(
            lambda p, mu_l: (p.to(f32) + lr * mu_l).to(p.dtype), params0, new_mu)
    return new_params, new_mu, count
