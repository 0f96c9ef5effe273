"""The LM's train, prefill and serve steps: on one device, and on a
(data, model) device mesh.

Port of ``repro.distributed.steps``. The reference builds each step for a
mesh with partition specs and hands it to ``jit``. The port has both:

* one device, no mesh: :func:`build_train_step` ``(cfg, tcfg)``,
  :func:`prefill_step` and :func:`serve_step`, plain functions;
* a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`): ``build_train_step
  (cfg, tcfg, mesh, shape)``, :func:`build_prefill_step` and
  :func:`build_serve_step`, each returning (step, in_specs, out_specs,
  arg_shapes) as the reference's builders do. Parameters, batches and
  caches are DTensors laid out by the reference's spec rules
  (:mod:`.sharding`; :func:`shard_state`, :func:`shard_caches`); the step
  runs the same model code under ``hints.activation_sharding`` and
  DTensor's sharding propagation (plain tensors made inside, such as
  positions and masks, are taken as replicated), and the hand-written
  kernels run on each rank's shard through ``local_map``
  (:mod:`repro_torch.kernels._mesh`). As with ``jit``, sharding does not
  change the function.

An encoder-decoder's prefill and serve steps take ``enc_out``, which the
caller computes once with ``models.transformer.encode_audio`` under
``torch.no_grad()``. :func:`params_shape` and :func:`state_shape` are meta
tensors: shapes with no memory, the reference's ``jax.eval_shape``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch import hints
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     leaves)
from repro_torch.optim.schedules import warmup_cosine

from . import sharding as shd
from .sharding import P


class TrainState(NamedTuple):
    """The reference's train state: LM parameters (``init_lm``'s tree),
    their AdamW moments (lists in the order of :func:`leaves`) and the
    step count (a Python int)."""
    params: dict
    opt: AdamWState
    step: int


def init_train_state(params: dict) -> TrainState:
    """Step 0 with zero moments; the parameters are made leaves that
    require grad."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params), step=0)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                     shape: Optional[ShapeConfig] = None):
    """-> ``train_step(state, batch) -> (state, loss)``, the reference's
    step on one device; with a ``mesh`` and ``shape`` the mesh step and its
    specs (:func:`_build_mesh_train_step`). On one device: ``lm_loss`` (remat as ``tcfg.remat``; with the MTP
    head's term where ``cfg.use_mtp``, deepseek-v3) and its gradient, the
    learning rate ``warmup_cosine(state.step)``, one AdamW update with
    ``tcfg``'s betas, weight decay and global-norm clip. The parameters
    (leaves that require grad, as :func:`init_train_state` and
    ``checkpoint.restore`` give them) and moments are updated in place (the
    reference returns new arrays); ``batch["tokens"]`` is (B, T) int on the
    parameters' device; the loss is a 0-d tensor there, detached.

    An encoder-decoder (whisper) also takes ``batch["frames"]`` (B,
    n_audio_frames, d_model): the loss is ``lm_loss`` against
    ``encode_audio`` of them, as the reference's step computes it, and the
    gradient reaches the encoder through cross-attention's keys and
    values (the encoder itself is not rematerialised, as in the
    reference)."""
    if mesh is not None:
        return _build_mesh_train_step(cfg, tcfg, mesh, shape)
    return _train_step_fn(cfg, tcfg)


def _train_step_fn(cfg, tcfg, batch_in=None, context=None):
    """The step's function; ``batch_in`` lays out the batch and ``context``
    opens the mesh contexts (the mesh step's)."""

    def train_step(state: TrainState, batch):
        with (context() if context else contextlib.nullcontext()):
            return _step(state, batch_in(batch) if batch_in else batch)

    def _step(state, batch):
        flat = leaves(state.params)
        enc = (T.encode_audio(state.params, cfg, batch["frames"])
               if cfg.is_encoder_decoder else None)
        loss = T.lm_loss(state.params, cfg, batch["tokens"], enc_out=enc,
                         remat=tcfg.remat)
        # an expert no token reached has no gradient: zero, as jax.grad
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        lr = warmup_cosine(state.step, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        params, opt = adamw_update(state.params, grads, state.opt,
                                   lr=float(lr), b1=tcfg.b1, b2=tcfg.b2,
                                   weight_decay=tcfg.weight_decay,
                                   grad_clip=tcfg.grad_clip)
        return TrainState(params=params, opt=opt,
                          step=state.step + 1), loss.detach()

    return train_step


@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 enc_out=None) -> torch.Tensor:
    """Full-sequence forward of (B, T) tokens -> (B, V) logits of the last
    position. The reference computes (B, T, V) logits and keeps the last
    column; the head works per position, so the port applies it to the
    last position only and never holds the (B, T, V) array. ``enc_out``:
    an encoder-decoder's encoder output (the reference's step encodes
    ``batch["frames"]`` itself)."""
    hidden = T.hidden_states(params, cfg, tokens, enc_out=enc_out)
    return T._lm_head(params, cfg, hidden[:, -1])


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
               index, enc_out=None):
    """One greedy decode step: (B, 1) token at position ``index`` ->
    ((B, 1) int32 argmax of the next-token logits, caches updated in
    place). ``enc_out``: an encoder-decoder's encoder output."""
    logits, caches = T.decode_step(params, cfg, token, caches, index,
                                   enc_out=enc_out)
    next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
    return next_tok[:, None], caches


# ------------------------------------------------------------------ mesh

def params_shape(cfg: ModelConfig) -> dict:
    """The port's LM parameter tree as meta tensors (no memory)."""
    from repro_torch.convert import lm_params_shape
    return lm_params_shape(cfg)


def state_shape(cfg: ModelConfig) -> TrainState:
    """The whole train state as meta tensors (no memory)."""
    params = params_shape(cfg)
    return TrainState(params=params, opt=adamw_init(params), step=0)


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in the order :func:`leaves` takes the
    parameters."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [s for sub in tree for s in _spec_leaves(sub)]


def state_specs(cfg: ModelConfig, mesh) -> TrainState:
    """The train state's specs: the moments take their parameter's."""
    pspec = shd.param_specs(params_shape(cfg), cfg, mesh)
    flat = _spec_leaves(pspec)
    return TrainState(params=pspec,
                      opt=AdamWState(mu=flat, nu=flat, count=P()), step=P())


def shd_to(spec_tree, mesh):
    """A spec tree -> the same tree of DTensor placements."""
    if isinstance(spec_tree, P):
        return shd.to_placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: shd_to(v, mesh) for k, v in spec_tree.items()}
    out = [shd_to(v, mesh) for v in spec_tree]
    return type(spec_tree)(*out) if hasattr(spec_tree, "_fields") \
        else type(spec_tree)(out)


def _dp_size(mesh) -> int:
    sizes = shd.axis_sizes(mesh)
    size = sizes["data"]
    if "pod" in sizes:
        size *= sizes["pod"]
    return size


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """long_500k: full-attention archs run the sliding-window variant
    (window 4096); natively sub-quadratic mixers are untouched."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        if cfg.sliding_window:
            return cfg.sliding_window
        return 4096
    return None


def shard_state(state: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """A one-device train state (every rank holding the same values) ->
    the mesh step's: parameters and moments as DTensors by
    :func:`state_specs`, the parameters leaves that require grad."""
    # the specs of this tree's own leaves, in its order (init_lm and the
    # converter order an encoder-decoder's or the MTP head's keys apart)
    pspec = shd.param_specs(state.params, cfg, mesh)
    params = shd.shard_tree(state.params, pspec, mesh)
    for p in leaves(params):
        p.requires_grad_(True)
    flat = _spec_leaves(pspec)
    mu = shd.shard_tree(list(state.opt.mu), flat, mesh)
    nu = shd.shard_tree(list(state.opt.nu), flat, mesh)
    return TrainState(params=params,
                      opt=AdamWState(mu=mu, nu=nu, count=state.opt.count),
                      step=state.step)


def shard_caches(caches, cfg: ModelConfig, mesh, *, batch: int):
    """``models.transformer.init_caches``' caches as DTensors by
    ``sharding.cache_specs``."""
    return shd.shard_tree(caches, shd.cache_specs(caches, cfg, mesh,
                                                  batch=batch), mesh)


def caches_shape(cfg: ModelConfig, batch: int, seq_len: int) -> list:
    """``init_caches``' caches as meta tensors (no memory)."""
    return T.init_caches(cfg, batch, seq_len, device="meta")


def _placed(t, spec, mesh):
    """``t`` laid out by ``spec``: a DTensor redistributed, a plain tensor
    (the same on every rank) distributed."""
    from torch.distributed.tensor import distribute_tensor
    placements = shd.to_placements(spec, mesh)
    if hints.is_dtensor(t):
        from repro_torch.kernels._mesh import relayout
        return relayout(t, mesh, placements)
    return distribute_tensor(t, mesh, placements)


def mesh_context(mesh, *, grad: bool = False):
    """The contexts a mesh step runs its model code under (hints on, plain
    tensors taken as replicated; no autograd unless ``grad``), for a
    caller that runs model code on sharded parameters itself (e.g.
    ``encode_audio`` once before serving)."""
    return _mesh_context(mesh, shd._default_dp_axes(mesh), grad=grad)()


def unshard(tree):
    """A tree of DTensors (dicts, lists, NamedTuples) -> the same tree of
    whole plain tensors on every rank (a collective)."""
    if isinstance(tree, dict):
        return {k: unshard(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [unshard(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if hints.is_dtensor(tree):
        return tree.full_tensor().detach()
    return tree


def unshard_state(state: TrainState) -> TrainState:
    """:func:`shard_state`'s inverse: whole plain tensors on every rank."""
    return TrainState(params=unshard(state.params),
                      opt=AdamWState(mu=unshard(list(state.opt.mu)),
                                     nu=unshard(list(state.opt.nu)),
                                     count=state.opt.count),
                      step=state.step)


def _mesh_context(mesh, dp_axes, *, grad: bool):
    from torch.distributed.tensor.experimental import implicit_replication

    @contextlib.contextmanager
    def ctx():
        with contextlib.ExitStack() as stack:
            if not grad:
                stack.enter_context(torch.no_grad())
            stack.enter_context(hints.activation_sharding(mesh, dp_axes))
            stack.enter_context(implicit_replication())
            yield
    return ctx


def _batch_specs(cfg, bspec):
    specs = {"tokens": bspec}
    if cfg.is_encoder_decoder:
        specs["frames"] = P(bspec[0], None, None)
    return specs


def _batch_shapes(cfg, shape):
    shapes = {"tokens": (shape.global_batch, shape.seq_len)}
    if cfg.is_encoder_decoder:
        shapes["frames"] = (shape.global_batch, cfg.n_audio_frames,
                            cfg.d_model)
    return shapes


def _build_mesh_train_step(cfg, tcfg, mesh, shape):
    """The mesh train step -> (train_step, in_specs, out_specs,
    arg_shapes). ``train_step(state, batch)`` takes :func:`shard_state`'s
    state and a batch of plain tensors (the same on every rank) or
    DTensors, and returns the new state (updated in place) and the loss,
    a plain 0-d tensor on every rank."""
    bspec = shd.batch_spec(mesh)
    sspecs = state_specs(cfg, mesh)
    batch_specs = _batch_specs(cfg, bspec)
    ctx = _mesh_context(mesh, shd._default_dp_axes(mesh), grad=True)

    def batch_in(batch):
        return {k: _placed(v, batch_specs[k], mesh) for k, v in batch.items()}

    inner = _train_step_fn(cfg, tcfg, batch_in, ctx)

    def train_step(state: TrainState, batch):
        state, loss = inner(state, batch)
        return state, loss.full_tensor()

    in_specs = (sspecs, batch_specs)
    out_specs = (sspecs, P())
    arg_shapes = (state_shape(cfg), _batch_shapes(cfg, shape))
    return train_step, in_specs, out_specs, arg_shapes


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       window_override: Optional[int] = None):
    """Prefill on the mesh: the full-sequence forward -> ONLY the last
    position's (B, V) logits (a DTensor: batch on the data axes, vocab on
    'model' where it divides). Returns (prefill_step, in_specs, out_specs,
    arg_shapes); ``prefill_step(params, batch)`` takes parameters sharded
    by ``in_specs[0]`` (mode "infer") and a batch of plain tensors or
    DTensors. ``window_override`` runs attention at that sliding window."""
    run_cfg = cfg if window_override is None \
        else cfg.replace(sliding_window=window_override)
    bspec = shd.batch_spec(mesh)
    pshape = params_shape(cfg)
    pspecs = shd.param_specs(pshape, cfg, mesh, mode="infer")
    batch_specs = _batch_specs(cfg, bspec)
    vocab_shardable = cfg.vocab_size % shd.axis_sizes(mesh)["model"] == 0
    out_specs = P(bspec[0], "model" if vocab_shardable else None)
    ctx = _mesh_context(mesh, shd._default_dp_axes(mesh), grad=False)

    def prefill_step(params, batch):
        with ctx():
            batch = {k: _placed(v, batch_specs[k], mesh)
                     for k, v in batch.items()}
            enc = (T.encode_audio(params, run_cfg, batch["frames"])
                   if cfg.is_encoder_decoder else None)
            hidden = T.hidden_states(params, run_cfg, batch["tokens"],
                                     enc_out=enc)
            logits = T._lm_head(params, run_cfg, hidden[:, -1])
            return _placed(logits, out_specs, mesh)

    in_specs = (pspecs, batch_specs)
    arg_shapes = (pshape, _batch_shapes(cfg, shape))
    return prefill_step, in_specs, out_specs, arg_shapes


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     window_override: Optional[int] = None):
    """One-token greedy decode on the mesh against a ``shape.seq_len``
    cache. Returns (serve_step, in_specs, out_specs, arg_shapes);
    ``serve_step(params, token, caches, index, enc_out=None)`` takes
    parameters by ``in_specs["params"]`` (mode "infer"), a (B, 1) token
    (plain or DTensor), :func:`shard_caches`' caches (updated in place)
    and the position, and returns ((B, 1) int32 next tokens as a DTensor
    by ``out_specs[0]``, the caches). The argmax takes the whole vocab on
    each rank: the logits are gathered over 'model' first."""
    run_cfg = cfg if window_override is None \
        else cfg.replace(sliding_window=window_override)
    bspec = shd.batch_spec(mesh)
    pshape = params_shape(cfg)
    pspecs = shd.param_specs(pshape, cfg, mesh, mode="infer")
    cshape = caches_shape(cfg, shape.global_batch, shape.seq_len)
    cspecs = shd.cache_specs(cshape, cfg, mesh, batch=shape.global_batch)
    b_shardable = shape.global_batch % _dp_size(mesh) == 0
    tok_spec = bspec if b_shardable else P(None)
    enc_spec = P(bspec[0] if b_shardable else None, None, None)
    ctx = _mesh_context(mesh, shd._default_dp_axes(mesh), grad=False)

    def serve_step(params, token, caches, index, enc_out=None):
        with ctx():
            token = _placed(token, tok_spec, mesh)
            if enc_out is not None:
                enc_out = _placed(enc_out, enc_spec, mesh)
            logits, caches = T.decode_step(params, run_cfg, token, caches,
                                           index, enc_out=enc_out)
            last = _placed(logits[:, -1, :], P(tok_spec[0], None), mesh)
            next_tok = last.argmax(dim=-1).to(torch.int32)
            return next_tok[:, None], caches

    arg_shapes = {
        "params": pshape,
        "token": (shape.global_batch, 1),
        "caches": cshape,
        "index": (),
    }
    in_specs = {"params": pspecs, "token": tok_spec, "caches": cspecs,
                "index": P()}
    out_specs = (tok_spec, cspecs)
    if cfg.is_encoder_decoder:
        arg_shapes["enc_out"] = (shape.global_batch, cfg.n_audio_frames,
                                 cfg.d_model)
        in_specs["enc_out"] = enc_spec
    return serve_step, in_specs, out_specs, arg_shapes
