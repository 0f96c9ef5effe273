"""Parameters carried across from the reference, and made in its layout.

The JAX package saves parameters with ``repro.checkpoint.npz
.save_pytree``: one ``.npz`` of path-keyed arrays (``encoder/down1/kernel``,
``decoder/up1/kernel``, ``codebook``, ...), with NHWC-style weights —
conv2d and conv2d_transpose kernels HWIO, conv1d kernels HIO, dense
weights (in, out). :func:`params_from_numpy` turns such a dict into the
port's parameters: 4-D kernels HWIO -> OIHW by ``transpose(3, 2, 0, 1)``,
conv1d HIO -> OIH by ``transpose(2, 1, 0)``, probe weights kept (in, out)
since the probe computes ``x @ w``. :func:`params_to_numpy` writes the
port's parameters back in the reference's keys and layouts.

:func:`init_numpy_params` draws parameters in the reference's layout with
the reference's init scales, so a program without JAX gets full-width
weights through the same converter: every kind's arrays are the
reference's own draw (:mod:`repro_torch.prng`).

The LM's parameters (``repro.models.transformer.init_lm``) are keyed
``embed``, ``final_norm/scale``, ``head`` (untied only) and
``segments/<s>/<block key>``, where each block array is stacked over the
segment's layers on a leading axis. An encoder-decoder (Whisper) adds
``cross_norm/...`` and ``cross/{wq,wk,wv,wo}`` to every decoder block,
``encoder/<block key>`` stacked over its ``n_encoder_layers`` and
``enc_final_norm/...``. A config with the MTP head (deepseek-v3) adds
``mtp/proj``, ``mtp/block/<block key>`` (one attention/dense block, not
stacked) and ``mtp/norm/...``. :func:`lm_params_from_numpy` unstacks them into
the port's per-layer dicts (dense weights stay (in, out): the port
computes ``x @ w``), :func:`lm_params_to_numpy` stacks them back, and
:func:`init_numpy_lm_params` draws them in the reference's layout.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.downstream import ConvClassifier, LinearProbe
from repro_torch.core.dvqae import DVQAEConfig, make_decoder, make_encoder
from repro_torch.models.transformer import check_supported, segment_plan
from repro_torch.nn import xlstm
from repro_torch.nn.ssm import dt_rank

_TO_TORCH = {4: (3, 2, 0, 1), 3: (2, 1, 0)}     # HWIO -> OIHW, HIO -> OIH
_TO_REF = {4: (2, 3, 1, 0), 3: (2, 1, 0)}       # OIHW -> HWIO, OIH -> HIO
_NETS = ("encoder", "decoder")


def _ref_key(net: str, name: str) -> str:
    """Port parameter name (``res0.c1.weight``) of ``net`` -> reference
    path (``encoder/res0/c1/kernel``); a top-level parameter keeps its name
    (the sequence kind's ``proj`` -> ``encoder/proj``)."""
    if "." not in name:
        return f"{net}/{name}"
    path, leaf = name.rsplit(".", 1)
    return f"{net}/" + path.replace(".", "/") + "/" + (
        "kernel" if leaf == "weight" else leaf)


def named_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(reference key, tensor) of every parameter in the training order:
    encoder, decoder, codebook."""
    out = [(_ref_key(net, n), p) for net in _NETS
           for n, p in params[net].named_parameters()]
    return out + [("codebook", params["codebook"])]


def to_reference_layout(t: torch.Tensor) -> np.ndarray:
    """A port weight (or its gradient) -> numpy in the reference's layout."""
    arr = t.detach().cpu().numpy()
    return arr.transpose(_TO_REF[arr.ndim]) if arr.ndim in _TO_REF else arr


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    """A reference array (HWIO, HIO or as is) -> the port's layout."""
    arr = np.asarray(arr, dtype=np.float32)
    return arr.transpose(_TO_TORCH[arr.ndim]) if arr.ndim in _TO_TORCH \
        else arr


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's parameters -> reference path-keyed arrays."""
    return {k: to_reference_layout(t) for k, t in named_leaves(params)}


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: DVQAEConfig, *,
                      device=None) -> dict:
    """Reference path-keyed arrays -> ``{"encoder": nn.Module, "decoder":
    nn.Module, "codebook": (K, M) tensor}`` on ``device`` (cuda unless
    ``device="cpu"``). A sequence DVQ-AE takes its ``d_model`` from the
    rows of ``encoder/proj``."""
    device = resolve_device(device)
    d_model = int(np.shape(flat["encoder/proj"])[0]) \
        if cfg.kind == "sequence" else None
    params = {"encoder": make_encoder(cfg, d_model=d_model),
              "decoder": make_decoder(cfg, d_model=d_model)}
    for net in _NETS:
        state = {}
        for name, p in params[net].named_parameters():
            key = _ref_key(net, name)
            arr = _to_torch_layout(flat[key])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {arr.shape} does not fit "
                                 f"the port's {tuple(p.shape)}")
            state[name] = torch.from_numpy(np.ascontiguousarray(arr))
        params[net].load_state_dict(state)
        params[net].to(device)
    # a copy: training updates the codebook in place
    codebook = torch.tensor(np.asarray(flat["codebook"], np.float32))
    params["codebook"] = codebook.to(device)
    return params


def server_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A DVQ-AE ``ServerState`` -> the path-keyed arrays of the reference's
    ``save_pytree(..., ServerState)``: ``.params/<key>``, the AdamW moments
    under ``.opt/.mu/<key>`` and ``.opt/.nu/<key>`` (the port keeps them as
    lists in :func:`named_leaves` order), ``.opt/.count`` and ``.step`` as
    int32 scalars. A state without an optimizer (``opt=None``) writes zero
    moments and count 0, which is what its first step starts from."""
    named = named_leaves(state.params)
    out = {f".params/{k}": to_reference_layout(t) for k, t in named}
    opt = state.opt
    for field in ("mu", "nu"):
        moments = [None] * len(named) if opt is None else getattr(opt, field)
        if len(moments) != len(named):
            raise ValueError(f"opt.{field} holds {len(moments)} moments for "
                             f"{len(named)} parameters")
        for (k, p), m in zip(named, moments):
            out[f".opt/.{field}/{k}"] = (
                np.zeros(out[f".params/{k}"].shape, np.float32) if m is None
                else to_reference_layout(m))
    out[".opt/.count"] = np.asarray(0 if opt is None else int(opt.count),
                                    np.int32)
    out[".step"] = np.asarray(int(state.step), np.int32)
    return out


def server_state_from_numpy(flat: Dict[str, np.ndarray], cfg: DVQAEConfig,
                            *, device=None):
    """Inverse of :func:`server_state_to_numpy` (and the reader of the
    reference's ``.state.npz``): a ``ServerState`` with its modules,
    codebook and AdamW moments on ``device`` (cuda unless
    ``device="cpu"``)."""
    from repro_torch.core.octopus import ServerState
    from repro_torch.optim.adamw import AdamWState
    device = resolve_device(device)
    params = params_from_numpy(
        {k[len(".params/"):]: v for k, v in flat.items()
         if k.startswith(".params/")}, cfg, device=device)
    named = named_leaves(params)

    def moments(field):
        out = []
        for k, p in named:
            arr = _to_torch_layout(flat[f".opt/.{field}/{k}"])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f".opt/.{field}/{k}: shape {arr.shape} does "
                                 f"not fit the port's {tuple(p.shape)}")
            out.append(torch.tensor(arr, device=device))
        return out

    opt = AdamWState(mu=moments("mu"), nu=moments("nu"),
                     count=int(flat[".opt/.count"]))
    return ServerState(params=params, opt=opt, step=int(flat[".step"]))


def load_npz(path: str, cfg: DVQAEConfig, *, device=None) -> dict:
    """``params_from_numpy`` of a reference ``save_pytree`` file, on
    ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    with np.load(path) as data:
        return params_from_numpy(dict(data), cfg, device=device)


def _conv_arrays(key, c_in: int, c_out: int, ksize: int, nd: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``init_conv2d``/``init_conv2d_transpose`` (nd 2: the
    kernel from the first half of ``split(key)``) or ``init_conv1d`` (nd 1:
    from ``key`` itself): a (k, [k,] c_in, c_out) kernel U(±1/sqrt(c_in *
    k^nd)) and a zero bias."""
    scale = 1.0 / math.sqrt(c_in * ksize ** nd)
    kk = prng.split(key, 2)[0] if nd == 2 else key
    return (prng.uniform(kk, (ksize,) * nd + (c_in, c_out), -scale, scale),
            np.zeros(c_out, np.float32))


def _conv_net_arrays(key, cfg: DVQAEConfig, net: str
                     ) -> Dict[str, np.ndarray]:
    """``init_{image,speech}_{encoder,decoder}(key, cfg)`` of the reference,
    path-keyed under ``net``: the same splits, in the same order."""
    nd = 2 if cfg.kind == "image" else 1
    h, M, C = cfg.hidden, cfg.latent_dim, cfg.in_channels
    if net == "encoder":
        n_first = 4
        layers = (("down1", C, h // 2, 4), ("down2", h // 2, h, 4),
                  ("mid", h, h, 3), ("to_latent", h, M, 1))
    else:
        n_first = 3
        up = 4 if nd == 2 else 3          # transposed 2-D convs, 1-D convs
        layers = (("from_latent", M, h, 3), ("up1", h, h // 2, up),
                  ("up2", h // 2, C, up))
    # the image decoder splits one key more than it uses: 4 + n_res
    ks = prng.split(key, n_first + cfg.n_res_blocks
                    + (net == "decoder" and nd == 2))
    named = [(name, ks[i], c_in, c_out, k)
             for i, (name, c_in, c_out, k) in enumerate(layers)]
    for i in range(cfg.n_res_blocks):
        k1, k2 = prng.split(ks[n_first + i], 2)
        named += [(f"res{i}/c1", k1, h, h, 3), (f"res{i}/c2", k2, h, h, 1)]
    flat = {}
    for name, k, c_in, c_out, ksize in named:
        kernel, bias = _conv_arrays(k, c_in, c_out, ksize, nd)
        flat[f"{net}/{name}/kernel"], flat[f"{net}/{name}/bias"] = \
            kernel, bias
    return flat


def init_numpy_params(cfg: DVQAEConfig, seed: int, *,
                      d_model: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """Encoder, decoder and codebook in the reference's layout: the
    reference's own arrays, ``init_dvqae(jax.random.PRNGKey(seed), cfg,
    d_model=d_model)``, drawn through :mod:`repro_torch.prng`. ``ke, kd,
    kc = split(key, 3)``; the ``sequence`` kind's (in, out) projections
    U(±1/sqrt(in)) from ``split(ke, 2)``, the ``image`` and ``speech``
    kinds' conv kernels U(±1/sqrt(c_in * k^d)) with zero biases through the
    reference's splits (:func:`_conv_net_arrays`); the N(0, 1) codebook
    from ``kc``."""
    K, M = cfg.codebook_size, cfg.latent_dim
    ke, kd, kc = prng.split(prng.prng_key(seed), 3)
    if cfg.kind == "sequence":
        k1, k2 = prng.split(ke, 2)
        s_enc, s_dec = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(M)
        return {"encoder/proj": prng.uniform(k1, (d_model, M), -s_enc, s_enc),
                "decoder/proj": prng.uniform(k2, (M, d_model), -s_dec, s_dec),
                "codebook": prng.normal(kc, (K, M))}
    if cfg.kind not in ("image", "speech"):
        raise ValueError(f"unknown DVQ-AE kind {cfg.kind!r}")
    return {**_conv_net_arrays(ke, cfg, "encoder"),
            **_conv_net_arrays(kd, cfg, "decoder"),
            "codebook": prng.normal(kc, (K, M))}


def probe_from_numpy(flat: Dict[str, np.ndarray], *,
                     device=None) -> LinearProbe:
    """Reference linear-probe arrays (w1, b1, w2, b2, w3, b3) -> module on
    ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    w1, w3 = flat["w1"], flat["w3"]
    head = LinearProbe(w1.shape[0], w3.shape[1], hidden=w1.shape[1])
    head.load_state_dict({k: torch.from_numpy(np.asarray(flat[k], np.float32))
                          for k in ("w1", "b1", "w2", "b2", "w3", "b3")})
    head.requires_grad_(False)
    return head.to(device)


def conv_classifier_from_numpy(flat: Dict[str, np.ndarray], *,
                               kind: str = "image",
                               device=None) -> ConvClassifier:
    """Reference conv-classifier arrays (``init_conv_classifier``'s tree,
    path-keyed: ``c1/kernel``, ``c1/bias``, ``c2/kernel``, ``c2/bias``,
    ``w``, ``b``, ``head``, ``hb``; HWIO or HIO kernels) -> module on
    ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    k1, head = np.asarray(flat["c1/kernel"]), np.asarray(flat["head"])
    model = ConvClassifier(k1.shape[-2], head.shape[1],
                           hidden=k1.shape[-1], kind=kind)
    state = {}
    for name, p in model.named_parameters():
        key = name.replace(".weight", "/kernel").replace(".", "/")
        arr = np.asarray(flat[key], np.float32)
        if key.endswith("kernel"):
            arr = arr.transpose(_TO_TORCH[arr.ndim])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit the "
                             f"{kind} classifier's {tuple(p.shape)}")
        state[name] = torch.tensor(arr)
    model.load_state_dict(state)
    return model.to(device)


def init_numpy_probe(in_dim: int, n_classes: int, *, hidden: int = 128,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Linear-probe arrays in the reference's layout and init scales."""
    rng = np.random.default_rng(seed)

    def dense(d_in: int, d_out: int) -> np.ndarray:
        s = 1.0 / math.sqrt(d_in)
        return rng.uniform(-s, s, (d_in, d_out)).astype(np.float32)

    return {"w1": dense(in_dim, hidden), "b1": np.zeros(hidden, np.float32),
            "w2": dense(hidden, hidden), "b2": np.zeros(hidden, np.float32),
            "w3": dense(hidden, n_classes),
            "b3": np.zeros(n_classes, np.float32)}



# --------------------------------------------------------------------- LM

def _norm_spec(prefix: str, kind: str, d: int) -> dict:
    spec = {f"{prefix}/scale": ((d,), "ones")}
    if kind != "rmsnorm":
        spec[f"{prefix}/bias"] = ((d,), "zeros")
    return spec


def lm_block_spec(cfg: ModelConfig, mixer: str = "attn",
                  ffn: str = "dense") -> Dict[str, tuple]:
    """One block of ``mixer`` (attn, mla, mamba, mlstm, slstm) and ``ffn``
    (dense, moe, none): reference key -> (shape, init). A block without a
    feed-forward has no ``post_norm``. Inits: "ones", "zeros", "dense"
    (U(±1/sqrt(shape[0])), the fan-in of an (in, out) weight or of a (K,
    C) conv kernel), "per_head" (U(±1/sqrt(shape[1])): an expert stack is
    (E, in, out), sLSTM's recurrent ``r`` (NH, DH, 4 DH)), "a_log"
    (``log(1..N)`` on every channel) and "dt_bias" (the inverse softplus
    of a log-uniform dt in [1e-3, 0.1]). An encoder-decoder's block also
    has ``cross_norm`` and ``cross/{wq,wk,wv,wo}``."""
    d = cfg.d_model
    spec = _norm_spec("pre_norm", cfg.norm, d)
    if mixer == "attn":
        hd = cfg.resolved_head_dim
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        spec.update({"mixer/wq": ((d, nq), "dense"),
                     "mixer/wk": ((d, nkv), "dense"),
                     "mixer/wv": ((d, nkv), "dense"),
                     "mixer/wo": ((nq, d), "dense")})
        if cfg.qk_norm:
            spec.update({"mixer/q_norm/scale": ((hd,), "ones"),
                         "mixer/k_norm/scale": ((hd,), "ones")})
    elif mixer == "mla":
        m, nq = cfg.mla, cfg.n_heads
        if m.q_lora_rank:
            spec.update({"mixer/wq_a": ((d, m.q_lora_rank), "dense"),
                         "mixer/q_norm/scale": ((m.q_lora_rank,), "ones"),
                         "mixer/wq_b": ((m.q_lora_rank, nq * m.qk_head_dim),
                                        "dense")})
        else:
            spec["mixer/wq"] = ((d, nq * m.qk_head_dim), "dense")
        spec.update({
            "mixer/wkv_a": ((d, m.kv_lora_rank + m.qk_rope_head_dim),
                            "dense"),
            "mixer/kv_norm/scale": ((m.kv_lora_rank,), "ones"),
            "mixer/wkv_b": ((m.kv_lora_rank,
                             nq * (m.qk_nope_head_dim + m.v_head_dim)),
                            "dense"),
            "mixer/wo": ((nq * m.v_head_dim, d), "dense")})
    elif mixer == "mamba":
        s = cfg.ssm
        di, N = s.expand * d, s.d_state
        dtr = dt_rank(cfg)
        spec.update({"mixer/in_proj": ((d, 2 * di), "dense"),
                     "mixer/conv/kernel": ((s.d_conv, di), "dense"),
                     "mixer/x_proj": ((di, dtr + 2 * N), "dense"),
                     "mixer/dt_proj": ((dtr, di), "dense"),
                     "mixer/dt_bias": ((di,), "dt_bias"),
                     "mixer/A_log": ((di, N), "a_log"),
                     "mixer/D": ((di,), "ones"),
                     "mixer/out_proj": ((di, d), "dense")})
    elif mixer == "mlstm":
        di = xlstm.inner_dim(cfg)
        spec.update({"mixer/up_proj": ((d, 2 * di), "dense"),
                     "mixer/conv/kernel": ((cfg.xlstm.conv_dim, di), "dense"),
                     "mixer/wq": ((di, di), "dense"),
                     "mixer/wk": ((di, di), "dense"),
                     "mixer/wv": ((di, di), "dense"),
                     "mixer/w_if": ((di, 2 * xlstm.NH), "dense"),
                     "mixer/skip_scale": ((di,), "ones"),
                     "mixer/down_proj": ((di, d), "dense")})
    else:
        dh, ffd = d // xlstm.NH, xlstm.ffn_dim(cfg)
        spec.update({"mixer/w_in": ((d, 4 * d), "dense"),
                     "mixer/r": ((xlstm.NH, dh, 4 * dh), "per_head"),
                     "mixer/bias": ((4 * d,), "zeros"),
                     "mixer/ffn_up": ((d, 2 * ffd), "dense"),
                     "mixer/ffn_down": ((ffd, d), "dense")})
    if cfg.is_encoder_decoder:
        hd = cfg.resolved_head_dim
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        spec.update(_norm_spec("cross_norm", cfg.norm, d))
        spec.update({"cross/wq": ((d, nq), "dense"),
                     "cross/wk": ((d, nkv), "dense"),
                     "cross/wv": ((d, nkv), "dense"),
                     "cross/wo": ((nq, d), "dense")})
    if ffn == "none":
        return spec
    spec.update(_norm_spec("post_norm", cfg.norm, d))
    if ffn == "dense":
        f = cfg.d_ff
        spec.update({"ffn/wi": ((d, f), "dense"), "ffn/wg": ((d, f), "dense"),
                     "ffn/wo": ((f, d), "dense")})
    else:
        m = cfg.moe
        E, f = m.n_experts, m.d_ff_expert
        spec.update({"ffn/router": ((d, E), "dense"),
                     "ffn/experts/wi": ((E, d, f), "per_head"),
                     "ffn/experts/wg": ((E, d, f), "per_head"),
                     "ffn/experts/wo": ((E, f, d), "per_head")})
        if m.n_shared_experts:
            fs = m.n_shared_experts * f
            spec.update({"ffn/shared/wi": ((d, fs), "dense"),
                         "ffn/shared/wg": ((d, fs), "dense"),
                         "ffn/shared/wo": ((fs, d), "dense")})
    return spec


def encoder_block_spec(cfg: ModelConfig) -> Dict[str, tuple]:
    """One layer of the Whisper encoder (pre_norm, self-attention,
    post_norm, dense MLP; no cross-attention), as :func:`lm_block_spec`
    names it."""
    return lm_block_spec(cfg.replace(is_encoder_decoder=False), "attn",
                         "dense")


def _stacks(cfg: ModelConfig):
    """(prefix, layers, block spec) of every stacked group of blocks: each
    segment, then an encoder-decoder's encoder."""
    out = [(f"segments/{s}", n, lm_block_spec(cfg, mixer, ffn))
           for s, (mixer, ffn, n) in enumerate(segment_plan(cfg))]
    if cfg.is_encoder_decoder:
        out.append(("encoder", cfg.n_encoder_layers,
                    encoder_block_spec(cfg)))
    return out


def _top_spec(cfg: ModelConfig) -> Dict[str, tuple]:
    """The arrays outside the stacks: final norm(s) and the MTP head's
    (``proj`` N(0, 1) * 0.02 as the embedding, one attention/dense block
    without a layer axis, its norm); ``embed`` and ``head`` are drawn
    apart."""
    d = cfg.d_model
    spec = _norm_spec("final_norm", cfg.norm, d)
    if cfg.is_encoder_decoder:
        spec.update(_norm_spec("enc_final_norm", cfg.norm, d))
    if cfg.use_mtp:
        spec["mtp/proj"] = ((2 * d, d), "normal")
        spec.update({f"mtp/block/{k}": v for k, v in
                     lm_block_spec(cfg, "attn", "dense").items()})
        spec.update(_norm_spec("mtp/norm", cfg.norm, d))
    return spec


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for key, t in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _tensor(flat, key: str, shape, device,
            dtype=torch.float32) -> torch.Tensor:
    arr = np.asarray(flat[key], dtype=np.float32)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {arr.shape} does not fit the "
                         f"config's {tuple(shape)}")
    return _cast(torch.tensor(arr), device, dtype)


def _cast(t: torch.Tensor, device, dtype) -> torch.Tensor:
    """A float32 host tensor in ``dtype`` on ``device``: the cast (to
    nearest even, as JAX's ``astype``) is made on the host, so a bfloat16
    leaf never occupies the card in float32."""
    return t.to(dtype).to(device)


def _lm_tree(cfg: ModelConfig, top_leaf, layer_leaf) -> dict:
    """The port's LM tree, each top-level leaf ``top_leaf(key, shape)`` and
    each layer's ``layer_leaf(key, stacked shape, j)`` (key the reference
    path, j the layer in its stack)."""
    V, d = cfg.vocab_size, cfg.d_model
    top = {"embed": top_leaf("embed", (V, d))}
    for key, (shape, _) in _top_spec(cfg).items():
        top[key] = top_leaf(key, shape)
    if not cfg.tie_embeddings:
        top["head"] = top_leaf("head", (d, V))
    params = _nest(top)
    params["segments"] = []
    for prefix, n, spec in _stacks(cfg):
        layers = [_nest({k: layer_leaf(f"{prefix}/{k}", (n,) + shape, j)
                         for k, (shape, _) in spec.items()})
                  for j in range(n)]
        if prefix == "encoder":
            params["encoder"] = layers
        else:
            params["segments"].append(layers)
    return params


def lm_params_shape(cfg: ModelConfig) -> dict:
    """The port's LM tree of ``cfg`` as meta tensors: shapes, no
    memory."""
    check_supported(cfg)

    def meta(shape):
        return torch.empty(shape, device="meta")

    return _lm_tree(cfg, lambda key, shape: meta(shape),
                    lambda key, shape, j: meta(shape[1:]))


def lm_params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                         device=None, mesh=None, specs=None) -> dict:
    """Reference path-keyed LM arrays -> the port's parameters on
    ``device`` (cuda unless ``device="cpu"``), each in ``cfg.param_dtype``
    (the arrays are float32, or the reference's bfloat16 leaves widened to
    float32, which is exact; the cast to bfloat16 rounds to nearest even,
    as JAX's ``astype``): ``embed``, ``final_norm``,
    ``head`` (untied only) and ``segments``, a list of per-layer dicts for
    each segment; an encoder-decoder's ``encoder`` (a list of per-layer
    dicts) and ``enc_final_norm``; the MTP head's ``mtp``.

    With a device ``mesh`` the leaves are DTensors laid out by ``specs``
    (the port's spec tree; default ``distributed.sharding.param_specs``
    in mode "train"): each rank copies only its own shard of each array
    (of each layer's slice of a stacked one), so with arrays memory-mapped
    from disk (:func:`mmap_npz`) the whole tree is never on one device or
    in one host's memory."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    if mesh is None:
        stacked: dict = {}

        def layer(key, shape, j):
            if key not in stacked:
                stacked[key] = _tensor(flat, key, shape, device, dtype)
            return stacked[key][j]

        return _lm_tree(cfg, lambda key, shape: _tensor(
            flat, key, shape, device, dtype), layer)
    from repro_torch.distributed import sharding as shd
    if specs is None:
        specs = shd.param_specs(lm_params_shape(cfg), cfg, mesh)
    spec_of = _flatten_specs(specs)

    def shard(key, shape, arr, spec):
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit the "
                             f"config's {tuple(shape)}")
        local = np.ascontiguousarray(
            arr[shd.local_shard(shape, spec, mesh)], dtype=np.float32)
        return shd.from_shard(_cast(torch.tensor(local), device, dtype),
                              shape, spec, mesh)

    def top(key, shape):
        return shard(key, shape, flat[key], spec_of[key])

    def layer(key, shape, j):
        arr = flat[key]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit the "
                             f"config's {tuple(shape)}")
        return shard(key, shape[1:], arr[j], spec_of[(key, j)])

    return _lm_tree(cfg, top, layer)


def _flatten_specs(specs: dict) -> dict:
    """A spec tree -> {reference key: spec} for top-level leaves and
    {(reference key, layer): spec} for the stacks' layers."""
    out = {}

    def walk(node, prefix, j=None):
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + "/", j)
            else:
                out[key if j is None else (key, j)] = v

    walk({k: v for k, v in specs.items()
          if k not in ("segments", "encoder")}, "")
    for s, layers in enumerate(specs["segments"]):
        for j, layer in enumerate(layers):
            walk(layer, f"segments/{s}/", j)
    for j, layer in enumerate(specs.get("encoder", ())):
        walk(layer, "encoder/", j)
    return out


def mmap_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``.npz`` written by ``np.savez`` (stored, not
    compressed), each memory-mapped read-only where it lies in the file:
    a rank that slices one copies only its slice from disk. A compressed
    member is read whole."""
    import zipfile
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    out[name] = np.lib.format.read_array(member)
                continue
            f.seek(info.header_offset + 26)      # the local header's lengths
            n_name, n_extra = np.frombuffer(f.read(4), dtype="<u2")
            start = info.header_offset + 30 + int(n_name) + int(n_extra)
            f.seek(start)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = np.lib.format._read_array_header(
                f, version)
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def lm_params_to_numpy(params: dict, cfg: ModelConfig
                       ) -> Dict[str, np.ndarray]:
    """The port's LM parameters -> reference path-keyed arrays, each block
    array stacked over its segment's (or the encoder's) layers; a bfloat16
    leaf widened to float32 (exact: numpy has no bfloat16)."""
    stacks = [(f"segments/{s}", layers)
              for s, layers in enumerate(params["segments"])]
    if "encoder" in params:
        stacks.append(("encoder", params["encoder"]))
    top = {k: v for k, v in params.items()
           if k not in ("segments", "encoder")}
    flat = {k: _numpy(t) for k, t in _flatten(top).items()}
    for prefix, layers in stacks:
        per_layer = [_flatten(bp) for bp in layers]
        for key in per_layer[0]:
            flat[f"{prefix}/{key}"] = np.stack(
                [_numpy(pl[key]) for pl in per_layer])
    return flat


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bfloat16 widened to float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def init_numpy_lm_params(cfg: ModelConfig, seed: int
                         ) -> Dict[str, np.ndarray]:
    """LM arrays in the reference's layout and init scales, float32, drawn
    from one ``default_rng(seed)`` in this order: the embedding N(0, 1) *
    0.02, the arrays outside the stacks (:func:`_top_spec`: final norms and
    the MTP head's), the untied head (N(0, 1) * 0.02, transposed), then
    each segment's arrays in :func:`lm_block_spec`'s order and inits, then an
    encoder-decoder's encoder stack (:func:`encoder_block_spec`); norm
    scales are ones and biases zeros. At the full width of a 13 B model this needs
    its size in host memory twice over: ``models.transformer.init_lm``
    draws on the card instead."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    V, d = cfg.vocab_size, cfg.d_model

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def draw(full, shape, init):
        """An array of ``full`` shape (``shape`` stacked over a segment's
        layers, or ``shape`` itself) with ``shape``'s init."""
        if init in ("dense", "per_head"):
            fan_in = shape[1] if init == "per_head" else shape[0]
            scale = np.float32(1.0 / math.sqrt(fan_in))
            return rng.random(full, dtype=np.float32) * (2 * scale) - scale
        if init == "a_log":
            return np.log(np.broadcast_to(
                np.arange(1, shape[-1] + 1, dtype=np.float32), full)).copy()
        if init == "dt_bias":
            u = rng.random(full, dtype=np.float32)
            dt = np.exp(u * np.float32(math.log(0.1) - math.log(1e-3))
                        + np.float32(math.log(1e-3)))
            return np.log(np.expm1(np.maximum(dt, np.float32(1e-4))))
        if init == "normal":
            return normal(full)
        return (np.ones if init == "ones" else np.zeros)(full, np.float32)

    flat = {"embed": normal((V, d))}
    for key, (shape, init) in _top_spec(cfg).items():
        flat[key] = draw(shape, shape, init)
    if not cfg.tie_embeddings:
        flat["head"] = np.ascontiguousarray(normal((V, d)).T)
    for prefix, n, spec in _stacks(cfg):
        for key, (shape, init) in spec.items():
            flat[f"{prefix}/{key}"] = draw((n,) + shape, shape, init) \
                .astype(np.float32)
    return flat
