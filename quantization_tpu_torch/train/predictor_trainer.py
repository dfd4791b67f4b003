"""Trainer for the JointCodebookLoss predictor.

PyTorch counterpart of ``quantization_tpu/train/predictor_trainer.py`` (the
reference's predictor workflow, `quantization/test_train_hdf5.py:79-134`):
against a FROZEN quantizer, predict each frame's codebook indexes from an
external feature vector (by default the frame itself), minimising the joint
autoregressive cross-entropy summed over the codebooks and averaged over
the batch.  Schedule: ``torch.optim.Adam`` with its defaults (optax's
``scale_by_adam()``), no weight decay, and StepLR(2000, 0.5) computed on
the host and set before each step (`test_train_hdf5.py:108-133`).

The targets come from ``quantizer.encode(..., as_bytes=False)`` with its
default ``search_method="auto"``, which on the card runs one search kernel
a step: K2 at the reference's 512-frame minibatch, K3 from its rung's
``min_frames`` (``ops/ladder.py``) at d512 and d1280.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional

import torch

from ..models import prediction
from ..models.quantizer import Quantizer

logger = logging.getLogger(__name__)


class PredictorTrainer:
    """Usage (`quantization/test_train_hdf5.py:79-134`)::

        trainer = PredictorTrainer(quantizer, predictor_channels=dim)
        for x in batches:                    # (B, dim) frames
            loss = trainer.step(x)           # predictor features default to x
        predictor = trainer.get_predictor()  # JointCodebookLoss module

    Runs on the quantizer's device.
    """

    def __init__(
        self,
        quantizer: Quantizer,
        predictor_channels: int,
        hidden_channels: int = 512,
        num_iters: int = 10000,
        lr: float = 1.0e-3,
        lr_step: int = 2000,
        lr_gamma: float = 0.5,
        *,
        encode_refine_iters: int = 5,
        noise_level: float = 0.0,
        seed: Optional[int] = None,
    ):
        self.quantizer = quantizer
        self.device = quantizer.device
        self.num_iters = num_iters
        self.lr = lr
        self.lr_step = lr_step
        self.lr_gamma = lr_gamma
        self.encode_refine_iters = encode_refine_iters
        self.noise_level = noise_level
        self.cur_iter = 0
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        init_gen = torch.Generator().manual_seed(seed)
        params = prediction.init_joint_codebook_params(
            init_gen, predictor_channels, quantizer.num_codebooks, hidden_channels,
            quantizer.codebook_size, device=self.device)
        self.params = prediction.JointCodebookParams(
            **{f: getattr(params, f).requires_grad_(True)
               for f in prediction.JOINT_CODEBOOK_FIELDS})
        self.opt = torch.optim.Adam(
            [getattr(self.params, f) for f in prediction.JOINT_CODEBOOK_FIELDS], lr=0.0)
        # the noise on the targets' frames, drawn on the device
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2**62, (), generator=init_gen)))

    def done(self) -> bool:
        return self.cur_iter >= self.num_iters

    def _lr_now(self) -> float:
        return self.lr * self.lr_gamma ** math.floor(self.cur_iter / self.lr_step)

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def step(self, x, predictor_features=None) -> float:
        """One optimisation step.  ``x``: (B, dim) frames; the frozen
        quantizer encodes the (optionally noised) frames to the target
        indexes; ``predictor_features`` defaults to ``x`` (the reference's
        setup: predict the codes from the un-noised frame,
        `test_train_hdf5.py:118-121`).  Returns the loss a frame."""
        x = self._put(x)
        target_in = x
        if self.noise_level > 0.0:
            target_in = x + self.noise_level * torch.randn(
                x.shape, generator=self._generator, device=self.device)
        with torch.no_grad():
            indexes = self.quantizer.encode(
                target_in, refine_indexes_iters=self.encode_refine_iters, as_bytes=False)
        feats = x if predictor_features is None else self._put(predictor_features)
        for group in self.opt.param_groups:
            group["lr"] = self._lr_now()
        self.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():  # a step differentiates even under a caller's no_grad
            loss = prediction.joint_codebook_loss(
                self.params, feats, indexes, reduction="sum") / feats.shape[0]
            loss.backward()
        self.opt.step()
        self.cur_iter += 1
        loss = float(loss.detach())
        if self.cur_iter % 200 == 0:
            logger.info("predictor iter %d, loss/frame %.3f", self.cur_iter, loss)
        return loss

    def get_predictor(self) -> prediction.JointCodebookLoss:
        """A :class:`~quantization_tpu_torch.models.prediction.JointCodebookLoss`
        holding (copies of) the trained parameters."""
        hidden, predictor_channels = self.params.linear1_w.shape
        return prediction.JointCodebookLoss(
            predictor_channels=predictor_channels,
            num_codebooks=self.quantizer.num_codebooks,
            hidden_channels=hidden,
            codebook_size=self.quantizer.codebook_size,
            params=self.params,
            device=self.device,
        )
