"""LoraRevolver: one frozen ViT trunk with a library of swappable LoRA
adapters (counterpart of `instance_based_loc_tpu/models/lora.py`; reference
`object_memory/lora_module.py:25-129`, a base HF ViT with PEFT adapters
hot-swapped by name, whose `encode_image` returns the CLS token).

An adapter is {block name: (down (D, r), up (r, 3 D))} for blocks named
`block{i}` as in the JAX package, added onto that block's qkv projection
(the adapter shape DATOR's `AttentionWithLoRA` trains). Switching folds the
adapter into a copy of the base weights; the library saves to and loads
from the JAX package's npz format (the pickled adapter dict in entry
`adapter`), so each package reads the other's files.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import resolve_device
from .vit import VARIANTS, ViT


class LoraRevolver:
    """Manage a library of LoRA adapters over one frozen ViT trunk, loaded
    by `vit_embedder.load_params` (random from seed 0 without a
    checkpoint). `cfg` overrides the variant's configuration."""

    def __init__(self, variant: str = "vit", rank: int = 4,
                 checkpoint_path: str | None = None, device="cuda", cfg=None):
        from .vit_embedder import load_params

        key = "dinov2" if variant == "dino" else variant
        self.cfg = VARIANTS[key] if cfg is None else cfg
        self.rank = rank
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = ViT(self.cfg)
        load_params(self.model, self.cfg, variant, checkpoint_path).eval()
        self.base_state = {k: v.clone()
                           for k, v in self.model.state_dict().items()}
        self.ckpt_library: dict[str, dict] = {}
        self.active: str | None = None

    def _merged_state(self, adapter: dict) -> dict:
        """The base weights with each block's down @ up added onto its qkv
        weight (the qkv Linear's weight is the JAX kernel transposed)."""
        state = dict(self.base_state)
        for block, (down, up) in adapter.items():
            name = f"blocks.{int(block.removeprefix('block'))}.attn.qkv.weight"
            base = self.base_state[name]
            delta = torch.as_tensor(np.asarray(down, np.float32)
                                    @ np.asarray(up, np.float32))
            state[name] = (base.float() + delta.T.to(base.device)).to(
                base.dtype)
        return state

    def load_lora_ckpt_from_file(self, ckpt_path: str, name: str):
        """Register an adapter from disk (lora_module.py:72-89): the npz this
        class saves, or a pickled {block: (down, up)} dict."""
        if ckpt_path.endswith(".npz"):
            from .vit_embedder import read_npz_tree
            adapter = read_npz_tree(ckpt_path, "adapter")
        else:
            with open(ckpt_path, "rb") as f:
                adapter = pickle.load(f)
        self.ckpt_library[name] = adapter

    def save_lora_ckpt(self, name: str, ckpt_path: str):
        adapter = {block: tuple(np.asarray(x) for x in pair)
                   for block, pair in self.ckpt_library[name].items()}
        np.savez(ckpt_path, adapter=np.frombuffer(pickle.dumps(adapter),
                                                  dtype=np.uint8))

    def register_adapter(self, name: str, adapter: dict):
        """adapter: {block_name: (down (D, r), up (r, 3 D))}."""
        self.ckpt_library[name] = adapter

    def switch_to_ckpt(self, name: str | None):
        """Hot-swap the active adapter (None: the base model)."""
        self.model.load_state_dict(
            self.base_state if name is None
            else self._merged_state(self.ckpt_library[name]))
        self.active = name

    @torch.no_grad()
    def encode_image(self, batch) -> np.ndarray:
        """(B, H, W, 3) preprocessed -> (B, E) CLS embeddings
        (lora_module.py:91-117 returns the CLS token)."""
        cls, _ = self.model(torch.as_tensor(np.asarray(batch, np.float32),
                                            device=self.device))
        return cls.cpu().numpy()

    def as_embedder(self, variant_for_preprocess: str = "vit"):
        """The batched ObjectMemory embedding callable, running the active
        adapter."""
        from .vit_embedder import preprocess_crop

        def embed(detections, **_):
            if len(detections) == 0:
                width = self.cfg.projection_dim or self.cfg.hidden_size
                return np.zeros((0, width), np.float32)
            batch = torch.stack([
                preprocess_crop(c, variant_for_preprocess,
                                self.cfg.image_size, self.device)
                for c in detections.crops])
            return self.encode_image(batch.cpu().numpy())

        return embed
