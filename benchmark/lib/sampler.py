"""The traffic's frames: the reference project's "typical neural-net
output" distribution (`quantization/test_quantization.py:16-32`), a 3-layer
random MLP with ReLUs and a LayerNorm plus 0.05 x its input, with the
weights of the key-42 MLP on which the committed quantizers were trained
(``benchmark/assets/mlp_sampler_d{dim}_key42.npz``).  The input noise is
drawn on the frames' device from a ``torch.Generator`` seeded by the run,
in a few large calls."""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 131072  # frames a call: bounds the activations' memory


class MlpSampler:
    def __init__(self, weights_path, dim: int, device):
        with np.load(weights_path) as z:
            self.w = {k: torch.from_numpy(np.array(z[k], np.float32)).to(device)
                      for k in z.files}
        if self.w["w1"].shape != (dim, dim):
            raise ValueError(f"{weights_path} is not a dim-{dim} sampler")
        self.dim, self.device = dim, torch.device(device)

    def _frames(self, noise: torch.Tensor) -> torch.Tensor:
        w = self.w
        h = torch.relu(noise @ w["w1"].t() + w["b1"])
        h = torch.relu(h @ w["w2"].t() + w["b2"])
        mu = h.mean(dim=-1, keepdim=True)
        var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + 1e-5)
        return h @ w["w3"].t() + w["b3"] + 0.05 * noise

    @torch.no_grad()
    def draw(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, dim) float32 frames on the sampler's device."""
        out = torch.empty(n, self.dim, device=self.device)
        for s in range(0, n, CHUNK):
            m = min(CHUNK, n - s)
            noise = torch.randn(m, self.dim, generator=generator, device=self.device)
            out[s:s + m] = self._frames(noise)
        return out


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of a run's seed;
    any whole seed, however large, maps into the generator's 64 bits."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g
