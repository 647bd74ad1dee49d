"""DATOR training and checkpoint I/O (counterpart of
`instance_based_loc_tpu/models/dator/train.py`; reference
`dator/processor/processor_depth.py`, `dator/solver/`).

One step (`train_step`) is a plain function of the train state, a batch and
its random draws: dequantise, augment, FourDNet's training forward, the
ReID losses, the gradient of the whole model, the optimiser's update. It
follows the JAX step's numerics:

* global-norm clipping sees every gradient, the frozen tower weights'
  included, because the JAX step differentiates the whole parameter tree
  (so the port computes the frozen weights' gradients too, and frees them
  after the norm); above `grad_clip` every gradient is scaled as optax
  scales it, (g / norm) * grad_clip, with no epsilon on the norm;
* frozen means frozen: only the trainable parameters (LoRA in the towers,
  everything outside them; all of them without `lora_only`) reach the
  optimiser, so frozen ones get no update and no weight decay, and the
  BatchNorm statistics move only in the forward pass;
* SGD is optax's add_decayed_weights + sgd(momentum): torch.optim.SGD with
  weight_decay and momentum, dampening 0; adam / adamw are torch's with
  optax's eps 1e-8; a trainable parameter without a gradient gets a zero
  one, so weight decay and momentum still move it as optax moves it;
* the learning rate of update n is `cosine_schedule(cfg)(n)`, optax's
  warmup_cosine_decay_schedule evaluated in fp32 at the update count
  before it increments, shifted by `schedule_offset_steps`;
* trainable weights are fp32 masters (the products still run in the
  model's dtype, as flax casts its fp32 parameters); frozen bf16 tower
  weights stay bf16.

Randomness comes in as explicit tensors (`StepDraws`): modality dropout's
`modality_p` and the eight augmentation draws. `make_step_draws` makes
them from a torch.Generator; tests feed in the JAX package's own draws.

The checkpoint format that crosses packages is the JAX package's flat npz:
one entry per parameter, keyed by its flax key path
("['params']['towers']['block0']['attn']['qkv']['kernel']"), fp32 values
stored as fp16. The port's DATOR modules keep the flax names and shapes, so
a state-dict key is that path without its collection, joined by dots
("towers.block0.attn.qkv.kernel"); parameters live in the "params"
collection and buffers (BatchNorm statistics) in "batch_stats". Resuming
uses `torch.save` files (`step_EPOCH.pt`: model, optimiser and step) in
place of the JAX trainer's orbax directories, which are not read.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from .fourdnet import FourDNet, FourDNetConfig, init_params
from .losses import center_loss, cross_entropy, margin_logits, reid_loss


def _npz_key(name: str, collection: str) -> str:
    return f"['{collection}']" + "".join(f"['{p}']" for p in name.split("."))


def _npz_keys(model: nn.Module) -> dict[str, str]:
    """State-dict key -> npz key of every entry of `model`."""
    buffers = {name for name, _ in model.named_buffers()}
    return {name: _npz_key(name, "batch_stats" if name in buffers
                           else "params")
            for name in model.state_dict()}


def save_params_npz(model: nn.Module, path: str) -> None:
    """The model's state as the JAX package's flat npz (fp32 values stored
    as fp16, as `save_params_npz` there does). Raises if a value does not
    fit in fp16. Stored without compression (`np.load` reads either):
    zlib saves ~8 % on fp16 weights and takes ~0.1 s per million of them
    on the host, 20-40 s for a full-width FourDNet, which the trainer would
    pay at every checkpoint and best-rank-1 epoch."""
    flat = {}
    for name, key in _npz_keys(model).items():
        arr = model.state_dict()[name].detach().float().cpu().numpy()
        half = arr.astype(np.float16)
        if not np.isfinite(half).all():
            raise ValueError(f"save_params_npz: non-finite values after the "
                             f"fp16 cast in {key} (fp32 max abs "
                             f"{np.abs(arr).max():.3e})")
        flat[key] = half
    np.savez(path, **flat)


def load_params_npz(model: nn.Module, path: str, strict: bool = True,
                    key_filter: list[str] | None = None) -> dict:
    """The npz's values for every entry of `model`'s state dict, in the
    model's types, as a state dict for `model.load_state_dict`.

    strict=False keeps the model's own value for an entry the npz lacks
    (a checkpoint written before the model grew it, e.g. the BNNeck). A
    shape mismatch always raises, naming both shapes. Extra npz entries
    (train-only heads) are ignored. key_filter: only entries whose npz key
    contains one of these substrings are loaded, the others keep the
    model's values (a selective warm start, e.g. ["towers", "aux_"])."""
    data = np.load(path)
    state = model.state_dict()
    out, missing, skipped = {}, [], 0
    for name, key in _npz_keys(model).items():
        current = state[name]
        if key_filter is not None and not any(f in key for f in key_filter):
            skipped += 1
            out[name] = current
            continue
        if key not in data:
            if strict:
                raise KeyError(f"npz checkpoint missing param {key}")
            missing.append(key)
            out[name] = current
            continue
        arr = data[key]
        if tuple(arr.shape) != tuple(current.shape):
            raise ValueError(
                f"npz checkpoint shape mismatch at {key}: checkpoint "
                f"{tuple(arr.shape)} vs model {tuple(current.shape)}")
        out[name] = torch.as_tensor(arr.astype(np.float32)).to(current.dtype)
    if missing:
        print(f"load_params_npz: {len(missing)} params not in {path}, "
              f"kept the model's values: {missing[:6]}"
              + (" ..." if len(missing) > 6 else ""))
    if skipped:
        print(f"load_params_npz: key_filter={key_filter} kept the model's "
              f"values for {skipped} non-matching entries")
    return out


def flat_npz_to_tree(path: str) -> dict:
    """Template-free load: the nested parameter dict straight from the
    npz's key paths; fp16 leaves come back fp32."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = re.findall(r"\['([^']+)'\]", key)
        if not parts:
            raise ValueError(f"unparseable npz key {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        arr = data[key]
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node[parts[-1]] = arr
    return tree


def params_from_jax(variables: dict, model: nn.Module) -> dict:
    """A flax variables tree of the JAX module ({"params": ...,
    "batch_stats": ...}, numpy or jax arrays) as `model`'s state dict.
    Every entry of the model must be in the tree; tree entries the model
    does not have (train-only heads) are ignored."""
    out = {}
    state = model.state_dict()
    for name, key in _npz_keys(model).items():
        node = variables
        for part in re.findall(r"\['([^']+)'\]", key):
            if part not in node:
                raise KeyError(f"the JAX tree has no {key}")
            node = node[part]
        arr = np.array(node, np.float32)
        if arr.shape != tuple(state[name].shape):
            raise ValueError(f"{key}: JAX {arr.shape} vs port "
                             f"{tuple(state[name].shape)}")
        out[name] = torch.as_tensor(arr).to(state[name].dtype)
    return out


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig, field for field (its comments give
    each field's reference)."""
    base_lr: float = 0.008
    weight_decay: float = 1e-4
    optimizer: str = "sgd"          # sgd | adam | adamw
    momentum: float = 0.9
    epochs: int = 240
    warmup_epochs: int = 5
    steps_per_epoch: int = 100
    grad_clip: float = 1000.0
    id_loss_weight: float = 1.0
    triplet_weight: float = 1.0
    label_smoothing: float = 0.0
    id_loss_type: str = "softmax"   # or arcface | cosface | amsoftmax | circle
    margin_scale: float = 30.0
    margin: float = 0.5
    center_loss_weight: float = 0.0
    lora_only: bool = True
    aux_tower_weight: float = 0.5
    token_ce_weight: float = 0.5
    triplet_feature: str = "post_bn_norm"   # or pre_bn | post_bn
    augment: bool = False
    schedule_offset_steps: int = 0
    gate_epoch: int = 20
    gate_id_loss: float = 5.5


def cosine_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init 0.01 base, peak base, end 0)
    over epochs * steps_per_epoch updates, as the JAX package builds it:
    linear warmup over `warmup` updates, then cosine decay to 0 at the
    horizon; `schedule_offset_steps` shifts the count. Evaluated in fp32
    in optax's order of operations, as optax evaluates it for an int32
    update count (its warmup start differs from 0.01 base by fp32
    rounding)."""
    f32 = np.float32
    total = cfg.epochs * cfg.steps_per_epoch
    warmup = max(min(cfg.warmup_epochs * cfg.steps_per_epoch,
                     max(total - 1, 0)), 1)
    decay = max(total, 2) - warmup
    init, peak = cfg.base_lr * 0.01, cfg.base_lr

    def schedule(count: int) -> float:
        count += cfg.schedule_offset_steps
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        t = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay)))
        return float(f32(peak) * cosine)

    return schedule


def trainable_names(model: nn.Module, lora_only: bool) -> list[str]:
    """Names of the parameters the optimiser updates: with lora_only only
    the LoRA matrices inside the towers, and every parameter outside them
    (the fusion and class heads have no pretrained weights). BatchNorm
    statistics are buffers and never train."""
    return [name for name, _ in model.named_parameters()
            if not name.startswith("towers.") or not lora_only
            or "lora" in name]


def make_optimizer(cfg: TrainConfig, params: list[nn.Parameter]):
    """The optimiser over the trainable parameters; its learning rate is
    set per update from `cosine_schedule`."""
    lr = cosine_schedule(cfg)(0)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser over the trainable parameters, and the
    number of updates done (the schedule's count)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    cfg: TrainConfig
    trainable: list[str]
    step: int = 0


def new_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Trainable parameters become fp32 masters; every parameter requires
    a gradient (the clip's norm reads the frozen ones' too)."""
    names = trainable_names(model, cfg.lora_only)
    params = dict(model.named_parameters())
    for name, p in params.items():
        if name in names:
            p.data = p.data.float()
        p.requires_grad_(True)
    return TrainState(model, make_optimizer(cfg, [params[n] for n in names]),
                      cfg, names)


def create_train_state(model_cfg: FourDNetConfig, train_cfg: TrainConfig,
                       seed: int = 0, pretrained_path: str | None = None,
                       device="cuda") -> TrainState:
    """FourDNet with seeded random weights (`init_params`), the centre-loss
    centres N(0, 1) when centre loss is on, and optionally pretrained ViT
    weights (an HF ViTModel `.bin` / `.pth` state dict) in both towers, as
    the reference inits its towers before the LoRA-only freeze."""
    from .transreid_vit import port_hf_vit_to_transreid
    dev = torch.device(device)
    with torch.device(dev):
        model = FourDNet(model_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_params(model, gen)
    if train_cfg.center_loss_weight > 0:
        model.register_parameter("center_centers", nn.Parameter(torch.randn(
            (model_cfg.num_classes, model_cfg.reduced_dim), generator=gen,
            device=dev)))
    if pretrained_path:
        sd = torch.load(pretrained_path, map_location="cpu",
                        weights_only=True)
        sd = {k.removeprefix("vit."): v.float().numpy()
              for k, v in sd.items()}
        ported = port_hf_vit_to_transreid(sd, model_cfg.backbone, towers=2)
        model.towers.load_state_dict(ported, strict=False)
    return new_train_state(model, train_cfg)


def dequantize_batch(rgb: torch.Tensor, depth: torch.Tensor):
    """Inverse of `PKSampler.load_batch(quantize=True)`: u8 rgb ->
    u8 (2/255) - 1; integer (u16-valued) depth (B, H, W) ->
    d (2/65535) - 1 repeated to 3 channels. Float inputs pass unchanged."""
    if rgb.dtype == torch.uint8:
        rgb = rgb.float() * (2.0 / 255.0) - 1.0
    if not depth.is_floating_point():
        d = depth.float() * (2.0 / 65535.0) - 1.0
        depth = d[..., None].expand(*d.shape, 3)
    return rgb, depth


class AugmentDraws(NamedTuple):
    """The eight per-sample draws of `augment_batch`, (B,) each, with the
    JAX package's ranges: flip and re_on booleans (p 0.5), dx and dy
    integers in [-10, 10], area in [0.02, 0.4) of the image, log_aspect in
    [log 0.3, log 3.3), ry and rx in [0, 1)."""
    flip: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    re_on: torch.Tensor
    area: torch.Tensor
    log_aspect: torch.Tensor
    ry: torch.Tensor
    rx: torch.Tensor


class StepDraws(NamedTuple):
    """A step's random draws: modality dropout's p (B,) in [0, 5) (None
    when the model does not drop modalities) and the augmentation draws
    (None when the step does not augment)."""
    modality_p: torch.Tensor | None
    augment: AugmentDraws | None


AUGMENT_PAD = 10


def make_step_draws(generator: torch.Generator, batch: int,
                    modality_dropout: bool, augment: bool) -> StepDraws:
    """A step's draws from `generator`, on its device."""
    dev = generator.device

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=dev)

    p = (torch.randint(0, 5, (batch,), generator=generator, device=dev)
         if modality_dropout else None)
    aug = None
    if augment:
        aug = AugmentDraws(
            flip=uniform() < 0.5,
            dx=torch.randint(-AUGMENT_PAD, AUGMENT_PAD + 1, (batch,),
                             generator=generator, device=dev),
            dy=torch.randint(-AUGMENT_PAD, AUGMENT_PAD + 1, (batch,),
                             generator=generator, device=dev),
            re_on=uniform() < 0.5, area=uniform(0.02, 0.4),
            log_aspect=uniform(math.log(0.3), math.log(3.3)),
            ry=uniform(), rx=uniform())
    return StepDraws(p, aug)


def augment_batch(rgb: torch.Tensor, depth: torch.Tensor,
                  draws: AugmentDraws):
    """The JAX package's train augmentation on the dequantised (B, H, W, 3)
    batch: a horizontal flip and a translation by (dy, dx) with zero fill
    (pad 10 + random crop), both shared by the two modalities, then random
    erasing of the rgb image only, filled with each image's mean colour."""
    b, h, w, _ = rgb.shape
    flip = draws.flip.reshape(b, 1, 1, 1)
    rgb = torch.where(flip, rgb.flip(2), rgb)
    depth = torch.where(flip, depth.flip(2), depth)

    pad = AUGMENT_PAD
    rows = (pad + draws.dy.long())[:, None] + torch.arange(h, device=rgb.device)
    cols = (pad + draws.dx.long())[:, None] + torch.arange(w, device=rgb.device)
    bidx = torch.arange(b, device=rgb.device)[:, None, None]

    def translate(img):
        padded = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
        return padded[bidx, rows[:, :, None], cols[:, None, :]]

    rgb, depth = translate(rgb), translate(depth)

    area = draws.area * (h * w)
    aspect = torch.exp(draws.log_aspect)
    eh = torch.clamp(torch.sqrt(area * aspect), 1, h - 1).to(torch.int32)
    ew = torch.clamp(torch.sqrt(area / aspect), 1, w - 1).to(torch.int32)
    y0 = (draws.ry * (h - eh)).to(torch.int32)
    x0 = (draws.rx * (w - ew)).to(torch.int32)
    yy = torch.arange(h, device=rgb.device)[None, :, None]
    xx = torch.arange(w, device=rgb.device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + eh)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + ew)[:, None, None]))
    mask = (inside & draws.re_on[:, None, None])[..., None]
    fill = torch.mean(rgb, dim=(1, 2), keepdim=True)
    rgb = torch.where(mask, fill, rgb)
    return rgb, depth


def step_losses(out, params: dict, labels: torch.Tensor, cfg: TrainConfig):
    """(total, components) of the JAX step's loss from FourDNet's
    `TrainOutputs`; every term in fp32."""
    feat = out.embedding.float()
    if cfg.triplet_feature == "pre_bn":
        tri_feat = out.embedding_raw.float()
    elif cfg.triplet_feature == "post_bn_norm":
        tri_feat = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True)
                           + 1e-12)
    elif cfg.triplet_feature == "post_bn":
        tri_feat = feat
    else:
        raise ValueError(f"unknown triplet_feature {cfg.triplet_feature!r}")
    cls_score = out.cls_score.float()
    id_score = cls_score
    if cfg.id_loss_type != "softmax":
        # the classifier kernel doubles as the cosine prototype matrix
        id_score = margin_logits(cfg.id_loss_type, feat,
                                 params["classifier.kernel"].float().T,
                                 labels, s=cfg.margin_scale, m=cfg.margin)
    total, aux = reid_loss(id_score, tri_feat, labels,
                           id_weight=cfg.id_loss_weight,
                           triplet_weight=cfg.triplet_weight,
                           label_smoothing=cfg.label_smoothing)
    if cfg.aux_tower_weight > 0:
        aux_ce = sum(cross_entropy(s.float(), labels, cfg.label_smoothing)
                     for s in out.aux_scores) / len(out.aux_scores)
        total = total + cfg.aux_tower_weight * aux_ce
        aux["aux_tower_loss"] = aux_ce
    if out.tok_scores is not None and cfg.token_ce_weight > 0:
        b, n, c = out.tok_scores.shape
        tok_ce = cross_entropy(out.tok_scores.float().reshape(b * n, c),
                               labels.repeat_interleave(n),
                               cfg.label_smoothing)
        total = total + cfg.token_ce_weight * tok_ce
        aux["token_ce"] = tok_ce
    if cfg.center_loss_weight > 0:
        c_loss = center_loss(feat, labels, params["center_centers"])
        total = total + cfg.center_loss_weight * c_loss
        aux["center_loss"] = c_loss
    aux["acc"] = torch.mean((torch.argmax(cls_score, -1) == labels).float())
    return total, aux


def apply_gradients(state: TrainState) -> torch.Tensor:
    """The optimiser's update from the gradients the parameters hold:
    the global norm over every gradient, optax's clip, then one update of
    the trainable parameters at `cosine_schedule(cfg)(state.step)`.
    Returns the norm before clipping."""
    cfg = state.cfg
    params = dict(state.model.named_parameters())
    grads = [p.grad for p in params.values() if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < cfg.grad_clip
    trainable = set(state.trainable)
    for name, p in params.items():
        if name not in trainable:
            p.grad = None
        elif p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad = torch.where(keep, p.grad, p.grad / norm * cfg.grad_clip)
    lr = cosine_schedule(cfg)(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return norm


def train_step(state: TrainState, rgb, depth, labels,
               draws: StepDraws) -> dict:
    """One CE + triplet step on a batch (quantised or normalised), with
    its random draws. Returns the loss, its components and the accuracy
    as 0-d tensors on the model's device (read them when the host needs
    them: reading syncs)."""
    cfg = state.cfg
    labels = labels.long()
    rgb, depth = dequantize_batch(rgb, depth)
    if cfg.augment:
        rgb, depth = augment_batch(rgb, depth, draws.augment)
    out = state.model(rgb, depth, training=True, modality_p=draws.modality_p)
    params = dict(state.model.named_parameters())
    total, aux = step_losses(out, params, labels, cfg)
    total.backward()
    aux["grad_norm"] = apply_gradients(state)
    return {"loss": total.detach(),
            **{k: v.detach() for k, v in aux.items()}}


def save_checkpoint(state: TrainState, ckpt_dir: str, epoch: int) -> str:
    """Model, optimiser and update count at ckpt_dir/step_EPOCH.pt."""
    path = os.path.join(ckpt_dir, f"step_{epoch}.pt")
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)
    return path


def restore_checkpoint(state: TrainState, ckpt_dir: str,
                       epoch: int) -> TrainState:
    """`save_checkpoint`'s file into a state built the same way."""
    ckpt = torch.load(os.path.join(ckpt_dir, f"step_{epoch}.pt"),
                      map_location=next(state.model.parameters()).device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state
