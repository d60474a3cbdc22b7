"""Train state (counterpart of the JAX package's ``training/state.py``): the
model (parameters and BatchNorm statistics), the optimizer and the step
count, with views in the Flax layout for checkpoints and the weight bridge.
Under a ``torch.distributed`` process group the train steps call the model
through ``DistributedDataParallel`` (:meth:`SegTrainState.train_module`);
the state itself, its checkpoints and its Flax views hold the unwrapped
model.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.parallel import distributed
from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    flax_to_state_dict,
    state_dict_to_flax,
)

# torch optimizer state slots -> optax state names
_SLOTS = {"adamw": (("exp_avg", "mu"), ("exp_avg_sq", "nu")),
          "sgd": (("momentum_buffer", "trace"),)}


class SegTrainState:
    """``model`` (float32 parameters on the training device), ``optimizer``
    (built by ``opt_def`` over the model's parameters) and ``step``, the
    number of updates applied so far: a host integer, so reading it never
    waits for the device.

    ``hyperparams`` (None, or e.g. ``{"learning_rate": 1e-3}``) are the
    optimizer's host-set hyperparameters, optax's ``inject_hyperparams``
    state: they are saved and restored with the optimizer state, as
    ``opt_state/hyperparams/<name>`` in float32."""

    def __init__(self, model: torch.nn.Module, opt_def: OptimizerDef,
                 optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0,
                 hyperparams: Optional[Dict[str, float]] = None) -> None:
        self.model = model
        self.opt_def = opt_def
        self.optimizer = optimizer or opt_def.build(model.parameters())
        self.step = step
        self.hyperparams = hyperparams
        self._ddp: Optional[torch.nn.Module] = None

    def train_module(self, entry: str = "forward", find_unused_parameters: bool = False):
        """What a train step calls: the model's ``entry`` method; under a
        process group, the same through ``DistributedDataParallel``, made
        once (``broadcast_buffers=False``: the global-batch BatchNorm keeps
        the statistics equal on every rank, and rank 0's would overwrite
        them otherwise). ``find_unused_parameters`` for a model whose loss
        leaves some parameters without a gradient (HRNet's last fusion)."""
        if not distributed.is_active():
            return getattr(self.model, entry)
        if self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            dev = next(self.model.parameters()).device
            self._ddp = DistributedDataParallel(
                _Entry(self.model, entry), device_ids=[dev] if dev.type == "cuda" else None,
                broadcast_buffers=False, find_unused_parameters=find_unused_parameters)
        return self._ddp

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``."""
        self.opt_def.step(self.optimizer, self.step)
        self.step += 1

    def variables(self) -> Dict[str, Any]:
        """``{"params", "batch_stats"}`` as Flax-layout numpy trees."""
        params, batch_stats = state_dict_to_flax(self.model.state_dict())
        return {"params": params, "batch_stats": batch_stats}

    def load_variables(self, params: Dict[str, Any], batch_stats: Dict[str, Any]) -> None:
        """Copy Flax-layout trees into the model, in place (the optimizer
        keeps its references to the parameters)."""
        self.model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)

    def opt_state(self) -> Dict[str, Any]:
        """The optimizer's moments as Flax-layout trees named as optax names
        them (AdamW ``mu``/``nu``, SGD ``trace``; zeros before the first
        update) and ``count``, the step."""
        out: Dict[str, Any] = {}
        named = list(self.model.named_parameters())
        for slot, key in _SLOTS[self.opt_def.name]:
            sd = {}
            for n, p in named:
                v = self.optimizer.state.get(p, {}).get(slot)
                sd[n] = torch.zeros_like(p) if v is None else v
            out[key] = state_dict_to_flax(sd)[0]
        out["count"] = np.asarray(self.step, np.int64)
        if self.hyperparams is not None:
            out["hyperparams"] = {k: np.asarray(v, np.float32)
                                  for k, v in self.hyperparams.items()}
        return out

    def load_opt_state(self, tree: Dict[str, Any]) -> None:
        """Inverse of :meth:`opt_state`; sets ``step`` from ``count`` and
        the hyperparameters from ``hyperparams`` where the tree holds them
        (in place, so that a schedule reading the dict sees them)."""
        self.step = int(tree["count"])
        if "hyperparams" in tree:
            restored = {k: float(v) for k, v in tree["hyperparams"].items()}
            if self.hyperparams is None:
                self.hyperparams = restored
            else:
                self.hyperparams.update(restored)
        named = dict(self.model.named_parameters())
        for slot, key in _SLOTS[self.opt_def.name]:
            sd = flax_to_state_dict(tree[key])
            if set(sd) != set(named):
                raise ValueError(f"optimizer slot {key!r} does not match the model's parameters")
            for n, p in named.items():
                st = self.optimizer.state[p]
                st[slot] = sd[n].to(device=p.device, dtype=p.dtype)
                if self.opt_def.name == "adamw":
                    st["step"] = torch.tensor(float(self.step), dtype=torch.float32)


class _Entry(torch.nn.Module):
    """``model.<entry>`` as a module's forward, for DDP, which hooks only
    ``forward`` (YOLO trains on ``levels``)."""

    def __init__(self, model: torch.nn.Module, entry: str) -> None:
        super().__init__()
        self.model = model
        self.entry = entry

    def forward(self, *args):
        return getattr(self.model, self.entry)(*args)


def create_seg_state(model: torch.nn.Module, opt_def: OptimizerDef,
                     device: Optional[torch.device] = None) -> SegTrainState:
    """The train state of ``model`` (moved to ``device`` when given, and set
    to train mode) with a fresh optimizer at step 0."""
    if device is not None:
        model.to(device)
    return SegTrainState(model.train(), opt_def)

