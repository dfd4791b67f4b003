"""Staged trainer for the multi-kmeans prototype.

PyTorch counterpart of ``quantization_tpu/train/multi_kmeans_trainer.py``
(the reference's training script, `multi_kmeans.py:331-407`): train
``iters_per_stage`` steps, grow the quantizer (cs -> cs^2, nc -> nc/2),
multiply the target frame entropy by 1.5 and halve the lr, repeat for
``num_stages`` stages.  The loss of a step is the expected reconstruction
loss + entropy_scale * class-entropy loss + |frame_entropy - target|
(`multi_kmeans.py:393`).  The optimiser is ``torch.optim.Adam(betas=(0.9,
0.9), eps=1e-9, weight_decay=1e-6)``, equal to the JAX package's
``add_decayed_weights(1e-6)`` + ``scale_by_adam(0.9, 0.9, 1e-9)``, rebuilt
at every growth; the StepLR(1000, 0.5) schedule is computed on the host.

Host randomness follows the JAX trainer: one
``numpy.random.default_rng(seed).integers(0, 2**31)`` seeds the CPU
generator of the initial centers, and that generator seeds the sampling
generator on the trainer's device.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..core.types import resolve_device
from ..models import multi_kmeans as mk


def make_optimizer(params: mk.MultiKmeansParams) -> torch.optim.Adam:
    """Adam(0.9, 0.9, eps=1e-9) with L2 weight decay 1e-6 folded into the
    gradient (`multi_kmeans.py:362-366`); the lr is set before each step."""
    return torch.optim.Adam([params.centers, params.frame_entropy_scale], lr=0.0,
                            betas=(0.9, 0.9), eps=1e-9, weight_decay=1e-6)


class MultiKmeansTrainer:
    """Usage::

        trainer = MultiKmeansTrainer(dim=512)
        while not trainer.done():
            trainer.step(x)        # x: (*, dim) fresh minibatch
        quantizer = trainer.get_quantizer()

    Runs on the GPU unless ``device`` says otherwise.
    """

    def __init__(
        self,
        dim: int,
        codebook_size: int = 4,
        num_codebooks: int = 16,
        num_stages: int = 3,
        iters_per_stage: int = 10000,
        lr: float = 0.001,
        target_frame_entropy: float = 0.2,
        entropy_scale: float = 1.0e-7,
        refine_iters: int = 4,
        *,
        seed: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.num_stages = num_stages
        self.iters_per_stage = iters_per_stage
        self.lr = lr
        self.target_frame_entropy = target_frame_entropy
        self.entropy_scale = entropy_scale
        self.refine_iters = refine_iters
        self.stage = 0
        self.iter_in_stage = 0
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self._rng = np.random.default_rng(seed)
        init_gen = torch.Generator().manual_seed(int(self._rng.integers(0, 2**31)))
        self._set_params(mk.init_multi_kmeans_params(init_gen, dim, codebook_size, num_codebooks))
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2**62, (), generator=init_gen)))

    def _set_params(self, params: mk.MultiKmeansParams) -> None:
        """Own fresh leaf copies of ``params`` and a fresh optimiser."""
        self.params = mk.MultiKmeansParams(
            *(t.detach().clone().to(self.device).requires_grad_(True)
              for t in (params.centers, params.frame_entropy_scale)))
        self.opt = make_optimizer(self.params)

    def done(self) -> bool:
        return self.stage >= self.num_stages

    def _lr_now(self) -> float:
        # StepLR(step_size=1000, gamma=0.5) within the stage; the base lr
        # halves each stage (`multi_kmeans.py:367,406`)
        base = self.lr * 0.5 ** self.stage
        return base * 0.5 ** math.floor(self.iter_in_stage / 1000)

    def _target_now(self) -> float:
        return self.target_frame_entropy * 1.5 ** self.stage

    def step(self, x) -> mk.StochasticRefineOut:
        """One optimisation step on a (*, dim) minibatch; returns the step's
        sampled indexes and losses (detached)."""
        if self.done():
            raise AssertionError("training is done")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, self.dim)
        for group in self.opt.param_groups:
            group["lr"] = self._lr_now()
        self.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():  # a step differentiates even under a caller's no_grad
            out = mk.forward(self.params, x, self._generator, self.refine_iters)
            total = (out.reconstruction_loss + self.entropy_scale * out.entropy_loss
                     + (out.frame_entropy - self._target_now()).abs())
            total.backward()
        self.opt.step()
        self.iter_in_stage += 1
        if self.iter_in_stage >= self.iters_per_stage:
            self.stage += 1
            self.iter_in_stage = 0
            if not self.done():
                self._set_params(mk.product_params(self.params.detach()))
        return mk.StochasticRefineOut(*(v.detach() for v in out))

    def get_quantizer(self) -> mk.MultiKmeansQuantizer:
        nc, cs, dim = self.params.centers.shape
        return mk.MultiKmeansQuantizer(dim, cs, nc, params=self.params.detach(),
                                       device=self.device)
