"""``Quantizer``: the reference's ``nn.Module`` surface over the functional
core.

Parameters and buffer carry the reference state-dict keys
(`quantization/quantization.py:38-59`): ``to_logits.weight``,
``to_logits.bias``, ``centers``, ``logits_scale``, ``centers_scale`` and
``id_buf`` (the 8 ASCII bytes of the hex identity).  Compute methods hand
the parameters to ``core`` and run on the module's device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from .. import core
from ..core.types import QuantizerConfig, QuantizerLosses, QuantizerParams, resolve_device
from ..utils.spans import span


class Quantizer(nn.Module):
    """Trainable multi-codebook ("direct-sum") vector quantizer.

    Encodes a (*, dim) vector into num_codebooks integer indexes (optionally
    packed into bytes); reconstruction is the sum of the selected codewords.
    Built on the GPU unless ``device`` says otherwise; without CUDA,
    ``device="cpu"`` must be passed.
    """

    def __init__(
        self,
        dim: int,
        codebook_size: int,
        num_codebooks: int,
        *,
        generator: Optional[torch.Generator] = None,
        params: Optional[QuantizerParams] = None,
        id_str: Optional[str] = None,
        scale_speed: float = 10.0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = QuantizerConfig(
            dim=dim,
            codebook_size=codebook_size,
            num_codebooks=num_codebooks,
            scale_speed=scale_speed,
        )
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(
                    int.from_bytes(os.urandom(4), "little"))
            params = core.init_quantizer_params(generator, self.config)
        nc, cs = num_codebooks, codebook_size
        # no default init: the weights come from ``params`` just below
        self.to_logits = nn.utils.skip_init(nn.Linear, dim, nc * cs, device=device)
        with torch.no_grad():
            self.to_logits.weight.copy_(params.to_logits_w)
            self.to_logits.bias.copy_(params.to_logits_b)
        self.centers = nn.Parameter(params.centers.detach().clone().to(device))
        self.logits_scale = nn.Parameter(
            params.logits_scale.detach().clone().reshape(()).to(device))
        self.centers_scale = nn.Parameter(
            params.centers_scale.detach().clone().reshape(()).to(device))
        id_str = id_str if id_str is not None else core.random_id()
        self.register_buffer(
            "id_buf", torch.tensor(list(id_str.encode("utf-8")), dtype=torch.uint8,
                                   device=device))

    # -- introspection ------------------------------------------------------

    @property
    def params(self) -> QuantizerParams:
        """The parameters as the functional core takes them (no copies)."""
        return QuantizerParams(
            centers=self.centers,
            to_logits_w=self.to_logits.weight,
            to_logits_b=self.to_logits.bias,
            logits_scale=self.logits_scale,
            centers_scale=self.centers_scale,
        )

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def codebook_size(self) -> int:
        return self.config.codebook_size

    @property
    def num_codebooks(self) -> int:
        return self.config.num_codebooks

    def get_id(self) -> str:
        return bytes(self.id_buf.tolist()).decode("utf-8")

    def show_init_invocation(self) -> str:
        return (
            f"quantization_tpu_torch.Quantizer(dim={self.dim}, "
            f"codebook_size={self.codebook_size}, num_codebooks={self.num_codebooks})"
        )

    def get_centers(self) -> torch.Tensor:
        return core.scaled_centers(self.params, self.config.scale_speed)

    def get_data_mean(self) -> torch.Tensor:
        return core.data_mean(self.params, self.config.scale_speed)

    # -- compute ------------------------------------------------------------

    @torch.no_grad()
    def encode(
        self,
        x: torch.Tensor,
        refine_indexes_iters: int = 5,
        as_bytes: bool = True,
        search_method: str = "auto",
        **search_kwargs,
    ) -> torch.Tensor:
        """Quantize ``x`` to byte codes.  ``search_method``:

        * "auto" (default): the fastest configuration measured on the GPU
          within 1% relative reconstruction error of the reference beam-5
          (the seqbeam kernel, ops/seqbeam.py); "beam" elsewhere.
        * "beam": the reference's pair-tree beam search.
        * "seqbeam": the sequential-beam kernel; ``refine_indexes_iters``
          counts beam sweeps.
        * "cdN+seqbeam": N coordinate-descent warm-start sweeps + kernel.
        * "cd": exact coordinate descent alone.
        * "gramv3": the Gram-table kernel (ops/gramv3.py); ``g_dtype="int8"``
          selects its int8 table.

        Extra ``search_kwargs`` (e.g. ``M=16``, ``R=4``) go to the kernel."""
        x = torch.as_tensor(x, device=self.device)
        with span("quantizer.encode", frames=x.numel() // self.config.dim):
            return core.encode(
                self.params, self.config, x, refine_indexes_iters, as_bytes,
                search_method=search_method, **search_kwargs,
            )

    @torch.no_grad()
    def decode(self, indexes: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        """Reconstruct (*, dim) from codes; ``use_kernel=True`` runs the
        fused bf16 decode (ops/decode.py)."""
        indexes = torch.as_tensor(indexes, device=self.device)
        return core.decode(self.params, self.config, indexes, use_kernel=use_kernel)

    def compute_loss(self, x: torch.Tensor, refine_indexes_iters: int = 0) -> QuantizerLosses:
        """The four loss terms on ``x`` with the exact beam search, with
        gradients into the module's parameters."""
        x = torch.as_tensor(x, device=self.device)
        return core.compute_loss(self.params, self.config, x, refine_indexes_iters)

    def compute_codebook_correlations(self) -> torch.Tensor:
        return core.codebook_correlations(self.params, self.config)

    def get_product_quantizer(self) -> "Quantizer":
        """New Quantizer with codebook_size**2 / num_codebooks//2, each output
        codebook formed from sums of pairs of input codebooks
        (`quantization/quantization.py:81-112`), on the same device, with a
        fresh identity like the reference's brand-new module."""
        new_config = self.config.product_config()
        return Quantizer(
            new_config.dim,
            new_config.codebook_size,
            new_config.num_codebooks,
            params=core.product_params(self.params, self.config),
            scale_speed=new_config.scale_speed,
            device=self.device,
        )
