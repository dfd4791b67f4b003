"""Two-phase quantizer trainer.

PyTorch counterpart of ``quantization_tpu/train/trainer.py`` (the reference
``QuantizerTrainer``, `quantization/quantization.py:577-742`): train with
codebook_size=16 and num_codebooks = 2*bytes_per_frame for
``phase_one_iters``, then form the product quantizer (codebook_size=256,
num_codebooks = bytes_per_frame) and train ``phase_two_iters`` more.

* The optimiser is ``torch.optim.Adam(betas=(0.9, 0.98), eps=1e-9,
  weight_decay=1e-6)``: weight decay folded into the gradient, as the JAX
  package's ``optax.add_decayed_weights`` + ``scale_by_adam`` do.  The
  halving StepLR schedule is computed on the host and set on the parameter
  group before every step.
* Host randomness comes from ``numpy.random.default_rng(seed)``, drawn in
  the JAX trainer's order: one ``integers(0, 2**31)`` at construction (it
  seeds the ``torch.Generator`` of the initial parameters), one ``random()``
  per :meth:`step` and one ``random(chunk)`` per :meth:`step_many` chunk, so
  that the choice between 1 and 2 refinement iterations matches the JAX
  trainer's step for step under the same seed.
* :meth:`step_many` is a Python loop over the steps, split into chunks
  where the JAX trainer splits its scans: at the phase switch and at the
  beam-finetune switch.
* Checkpoints are the JAX trainer's format: the leaves of
  ``(params, opt_state)`` (five parameters, the Adam count, its first and
  second moments) and the same ``meta`` keys, so :meth:`load_checkpoint`
  resumes a run that the JAX package saved, and the other way round.
* ``init="multi_kmeans"`` fits the phase-1 codebooks with a short
  :class:`~quantization_tpu_torch.train.multi_kmeans_trainer.MultiKmeansTrainer`
  run on ``init_data`` (``init_iters`` steps at batch min(512, N), the
  batches drawn from the trainer's own host RNG after the parameters' seed,
  as the JAX trainer draws them), then starts ``to_logits`` as a copy of
  the fitted centers (``core.init_quantizer_params_from_centers``).

* ``mesh=`` (a :class:`~quantization_tpu_torch.parallel.mesh.Mesh`; one
  process a device) trains on the mesh.  Each rank's :meth:`step` and
  :meth:`step_many` take that rank's own rows of the global batch (full
  dim); the global batch is their concatenation over the 'data' axis in
  rank order, every rank passes the same number of rows, and every rank
  makes the same calls.  Each step is the step of the whole global batch,
  as the JAX trainer's GSPMD step is: the loss's partial sums are
  all-reduced before each nonlinear function, and every gradient is summed
  once after ``backward()``, as one flat bucket, before Adam.  With a
  'model' axis each rank keeps its slice of ``centers`` and
  ``to_logits_w`` over dim and its dim columns of the frames; every
  contraction over dim is summed over the model group, so every rank takes
  the same indexes, and a kernel search runs at full width on the gathered
  codebooks and frames.  Every rank starts from rank 0's parameters and
  host RNG state.  :meth:`get_quantizer`, :meth:`save_checkpoint` (rank 0
  writes) and :meth:`load_checkpoint` (``mesh=``) gather and re-slice, so a
  checkpoint is the JAX format whatever the mesh; each is a collective that
  every rank calls.  Rank 0 logs.
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import core
from ..core.types import LOCAL, QuantizerConfig, QuantizerLosses, QuantizerParams, \
    resolve_device
from ..models.quantizer import Quantizer
from ..parallel.mesh import MeshReducer, Sharding, quantizer_param_sharding
from ..utils.torch_interop import PARAM_FIELDS, params_from_numpy

logger = logging.getLogger(__name__)

N_LEAVES = 1 + 3 * len(PARAM_FIELDS)  # params, Adam count, first and second moments


def make_optimizer(params: QuantizerParams) -> torch.optim.Adam:
    """Adam(0.9, 0.98, eps=1e-9) with L2 weight decay 1e-6 folded into the
    gradient (`quantization/quantization.py:722-725`).  The learning rate is
    set on the parameter group before each step."""
    return torch.optim.Adam([getattr(params, f) for f in PARAM_FIELDS], lr=0.0,
                            betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)


def total_loss(losses: QuantizerLosses, entropy_scale: float = 0.01) -> torch.Tensor:
    """recon + logprob + entropy_scale * logits_entropy
    (`quantization/quantization.py:682,708-710`)."""
    return (losses.rel_reconstruction_loss + losses.logprob_loss
            + entropy_scale * losses.logits_entropy_loss)


def _fit_multi_kmeans_centers(config: QuantizerConfig, data: torch.Tensor, iters: int,
                              rng: np.random.Generator) -> torch.Tensor:
    """The phase-1 codebooks fitted by ``iters`` steps of a one-stage
    multi-kmeans run on ``data`` (on the trainer's device), its seed and
    batches drawn from ``rng`` as the JAX trainer draws them."""
    from .multi_kmeans_trainer import MultiKmeansTrainer

    data = data.reshape(-1, config.dim)
    t = MultiKmeansTrainer(config.dim, codebook_size=config.codebook_size,
                           num_codebooks=config.num_codebooks, num_stages=1,
                           iters_per_stage=iters, seed=int(rng.integers(0, 2**31)),
                           device=data.device)
    batch = min(512, data.shape[0])
    for _ in range(iters):
        sel = rng.integers(0, data.shape[0], batch)
        t.step(data[torch.from_numpy(sel).to(data.device)])
    return t.params.centers.detach()


class QuantizerTrainer:
    """Usage (the lifecycle of `quantization/quantization.py:604-611`)::

        trainer = QuantizerTrainer(dim=512, bytes_per_frame=8)
        while not trainer.done():
            trainer.step(x)        # x: (*, dim) fresh minibatch
        quantizer = trainer.get_quantizer()

    Runs on the GPU unless ``device`` says otherwise; without CUDA,
    ``device="cpu"`` must be passed.
    """

    def __init__(
        self,
        dim: int,
        bytes_per_frame: int,
        device=None,
        phase_one_iters: int = 10000,
        phase_two_iters: int = 10000,
        lr: float = 0.005,
        *,
        seed: Optional[int] = None,
        two_iter_prob: float = 0.5,
        entropy_scale: float = 0.01,
        diagnostics: bool = True,
        mesh=None,
        train_search: str = "auto",
        beam_finetune_iters: Optional[int] = None,
        init: str = "default",
        init_data=None,
        init_iters: int = 300,
    ):
        if bytes_per_frame not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"bytes_per_frame must be a power of 2 up to 32, got {bytes_per_frame}")
        if init not in ("default", "multi_kmeans"):
            raise ValueError(f"unknown init {init!r}")
        if init == "multi_kmeans" and init_data is None:
            raise ValueError("init='multi_kmeans' needs init_data")
        self.mesh = mesh
        self._reducer = LOCAL if mesh is None else MeshReducer(mesh)
        self._shardings = None if mesh is None else quantizer_param_sharding(mesh)
        self._lead = mesh is None or mesh.rank == 0  # the rank that logs
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self.phase_one_iters = phase_one_iters
        self.phase_two_iters = phase_two_iters
        self.cur_iter = 0
        self.lr = lr
        self.two_iter_prob = two_iter_prob
        self.entropy_scale = entropy_scale
        self.diagnostics = diagnostics
        # "auto" trains with the exact beam (full-schedule parity with the
        # reference); a kernel search ("seqbeam", "gramv3", "gramv3-int8")
        # runs in phase 2 only, and its final ``beam_finetune_iters`` steps
        # run the exact beam again.  The default tail is 1000 steps for a
        # kernel search and none for the beam, clamped to phase 2
        # (quantization_tpu/train/trainer.py:222-252).
        self.train_search = train_search
        if beam_finetune_iters is None:
            beam_finetune_iters = 0 if train_search in ("auto", "beam") else 1000
        self.beam_finetune_iters = min(int(beam_finetune_iters), phase_two_iters)

        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self._seed = seed
        self._rng = np.random.default_rng(seed)

        # phase 1: codebook_size=16, num_codebooks = 2 * bytes_per_frame
        # (`quantization/quantization.py:627-628`)
        self.config = QuantizerConfig(dim=dim, codebook_size=16, num_codebooks=bytes_per_frame * 2)
        generator = torch.Generator().manual_seed(int(self._rng.integers(0, 2**31)))
        if init == "multi_kmeans":
            centers = _fit_multi_kmeans_centers(self.config, self._put(init_data), init_iters,
                                                self._rng)
            params = core.init_quantizer_params_from_centers(generator, self.config, centers,
                                                             device=self.device)
        else:
            params = core.init_quantizer_params(generator, self.config, device=self.device)
        if mesh is not None:
            # the ranks' seeds (when drawn here) and multi-kmeans init_data may
            # differ; the JAX trainer has one copy of each
            self._rng.bit_generator.state = mesh.broadcast_object(self._rng.bit_generator.state)
            for f in PARAM_FIELDS:
                mesh.broadcast_(getattr(params, f))
        self._set_params(self._shard(params))
        self.start_time = time.time()
        self._done_logged = False

    # ------------------------------------------------------------------ API

    def done(self) -> bool:
        ans = self.cur_iter > self.phase_one_iters + self.phase_two_iters
        if ans and not self._done_logged and self._lead:
            logger.info(
                "Elapsed time, training model of dim=%d, num_codebooks=%d, "
                "codebook_size=%d, is: %.2f seconds.", self.config.dim,
                self.config.num_codebooks, self.config.codebook_size,
                time.time() - self.start_time)
            self._done_logged = True
        return ans

    def get_quantizer(self) -> Quantizer:
        """The trained quantizer (whole, on every rank of a mesh)."""
        if self.cur_iter < self.phase_one_iters + self.phase_two_iters:
            raise AssertionError(
                f"training is not done: iteration {self.cur_iter} of "
                f"{self.phase_one_iters + self.phase_two_iters}")
        return Quantizer(self.config.dim, self.config.codebook_size, self.config.num_codebooks,
                         params=self._whole_params(), device=self.device)

    def step(self, x) -> QuantizerLosses:
        """One optimisation step on a (*, dim) minibatch (under a mesh, this
        rank's rows of it); returns the step's loss terms (detached), those
        of the whole batch."""
        x = self._cols(self._put(x).reshape(-1, self.config.dim))
        num_iters = 2 if self._rng.random() < self.two_iter_prob else 1
        losses = self._train_step(x, num_iters, self._lr_for_iter(self.cur_iter),
                                  self._search_for_config(self.cur_iter))
        if self.diagnostics and self.cur_iter % 200 == 0:
            self._log_diagnostics(x, losses)
        if self.diagnostics and self.cur_iter % 2000 == 0 and self.cur_iter > 0:
            self._log_correlations()
        if self.cur_iter == self.phase_one_iters:
            self._begin_second_phase()
        self.cur_iter += 1
        return losses

    def step_many(self, xs) -> List[QuantizerLosses]:
        """``xs.shape[0]`` optimisation steps on (K, B, dim) minibatches,
        equal to K calls of :meth:`step` without the per-200-step
        diagnostics, with the JAX trainer's chunking and host draws.  Returns
        each step's loss terms (detached)."""
        xs = self._put(xs)
        if xs.ndim != 3 or xs.shape[-1] != self.config.dim:
            raise ValueError(f"expected (K, B, {self.config.dim}) minibatches, got "
                             f"{tuple(xs.shape)}")
        xs = self._cols(xs)
        out = []
        pos, K = 0, xs.shape[0]
        while pos < K:
            # the phase switch fires after the step at cur_iter ==
            # phase_one_iters (`quantization/quantization.py:717`); chunks
            # also break at the beam-finetune switch
            if self.cur_iter <= self.phase_one_iters:
                room = self.phase_one_iters - self.cur_iter + 1
            elif self.cur_iter < self._finetune_start():
                room = self._finetune_start() - self.cur_iter
            else:
                room = self.phase_one_iters + self.phase_two_iters - self.cur_iter + 1
                if room <= 0:
                    room = K - pos  # already done; just run them
            chunk = min(K - pos, room)
            use2s = self._rng.random(chunk) < self.two_iter_prob
            search = self._search_for_config(self.cur_iter)
            for i in range(chunk):
                out.append(self._train_step(xs[pos + i], 2 if use2s[i] else 1,
                                            self._lr_for_iter(self.cur_iter + i), search))
            self.cur_iter += chunk
            pos += chunk
            if self.cur_iter == self.phase_one_iters + 1:
                self._begin_second_phase()
            if self.diagnostics and self.cur_iter % 2000 < chunk and self.cur_iter > chunk:
                self._log_correlations()
        return out

    # ------------------------------------------------------------- internals

    def _put(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def _cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dim columns of ``x`` (all of them without a model
        axis)."""
        if self.mesh is None:
            return x
        return Sharding(self.mesh, (None,) * (x.ndim - 1) + ("model",)).take(x)

    def _part(self, field: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``t`` of parameter ``field``."""
        return t if self.mesh is None else getattr(self._shardings, field).take(t)

    def _whole(self, field: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part ``t`` (a collective)."""
        return t if self.mesh is None else getattr(self._shardings, field).gather(t)

    def _shard(self, params: QuantizerParams) -> QuantizerParams:
        return QuantizerParams(**{f: self._part(f, getattr(params, f)) for f in PARAM_FIELDS})

    def _whole_params(self) -> QuantizerParams:
        return QuantizerParams(**{f: self._whole(f, getattr(self.params, f).detach())
                                  for f in PARAM_FIELDS})

    def _set_params(self, params: QuantizerParams) -> None:
        """Own fresh leaf copies of ``params`` and a fresh optimiser."""
        self.params = QuantizerParams(**{
            f: getattr(params, f).detach().clone().to(self.device).requires_grad_(True)
            for f in PARAM_FIELDS})
        self.opt = make_optimizer(self.params)

    def _train_step(self, x: torch.Tensor, refine_iters: int, lr: float,
                    search: str) -> QuantizerLosses:
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():  # a step differentiates even under a caller's no_grad
            losses = core.compute_loss(self.params, self.config, x, refine_iters,
                                       search_method=search, reducer=self._reducer)
            total_loss(losses, self.entropy_scale).backward()
        if self.mesh is not None:
            self._sum_grads(x.shape[0])
        self.opt.step()
        return QuantizerLosses(*(v.detach() for v in losses))

    def _sum_grads(self, rows: int) -> None:
        """Sum each rank's share of the gradients.  The dim-split leaves and
        ``to_logits_b`` (whose gradient is whole on every rank of a model
        group: the logits are summed before it) sum over the data group; the
        two scales, which every dim slice feeds, over the model group too.
        One flat bucket, which also carries the row count to check that
        every rank passed the same number of rows."""
        mesh = self.mesh
        params = [getattr(self.params, f) for f in PARAM_FIELDS]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if mesh.shape["model"] > 1:
            i, j = PARAM_FIELDS.index("logits_scale"), PARAM_FIELDS.index("centers_scale")
            grads[i], grads[j] = mesh.all_reduce(torch.stack([grads[i], grads[j]]), "model")
        count = torch.full((1,), float(rows), device=self.device)
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads] + [count]), "data")
        if float(flat[-1]) != rows * mesh.shape["data"]:
            raise ValueError(f"every rank of the data axis must pass the same number of rows; "
                             f"this rank passed {rows} of {float(flat[-1]):.0f}")
        for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def _finetune_start(self) -> int:
        """First iteration of the exact-beam finetune tail (see
        ``beam_finetune_iters``); past the end when disabled."""
        total = self.phase_one_iters + self.phase_two_iters
        return total + 1 - max(0, self.beam_finetune_iters)

    def _search_for_config(self, cur_iter: Optional[int] = None) -> str:
        if cur_iter is not None and cur_iter >= self._finetune_start():
            return "beam"
        if self.train_search == "auto":
            return "beam"
        if self.train_search == "seqbeam":
            from ..ops.seqbeam import NARROW_DIM, SEQBEAM_SUPPORTED

            # the training search's beam (M=16, f32 E) runs up to NARROW_DIM
            ok = SEQBEAM_SUPPORTED(self.config) and self.config.dim <= NARROW_DIM
            return "seqbeam" if ok else "beam"
        if self.train_search in ("gramv3", "gramv3-int8"):
            # phase 1 runs at codebook_size 16, where no kernel applies
            from ..ops.gramv3 import GRAMV3_SUPPORTED

            return self.train_search if GRAMV3_SUPPORTED(self.config) else "beam"
        return self.train_search

    def _lr_for_iter(self, cur_iter: int) -> float:
        """torch StepLR(step_size=phase_iters/4, gamma=0.5), stepped once per
        iteration, rebuilt with base lr halved at the phase switch
        (`quantization/quantization.py:726-738`)."""
        if cur_iter <= self.phase_one_iters:
            epoch, base, step_size = cur_iter, self.lr, self.phase_one_iters / 4
        else:
            epoch = cur_iter - self.phase_one_iters - 1
            base, step_size = self.lr * 0.5, self.phase_two_iters / 4
        return base * 0.5 ** math.floor(epoch / step_size)

    def _begin_second_phase(self) -> None:
        """Swap in the product quantizer and a fresh optimiser; the base lr
        halves through :meth:`_lr_for_iter`
        (`quantization/quantization.py:732-738`)."""
        params = core.product_params(self.params, self.config)
        self.config = self.config.product_config()
        self._set_params(params)

    @torch.no_grad()
    def _log_diagnostics(self, x: torch.Tensor, losses: QuantizerLosses) -> None:
        det = [float(core.compute_loss(self.params, self.config, x, j,
                                       reducer=self._reducer).rel_reconstruction_loss)
               for j in range(6)]
        if not self._lead:
            return
        phase = 1 if self.cur_iter <= self.phase_one_iters else 2
        i = self.cur_iter - self.phase_one_iters if phase > 1 else self.cur_iter
        logger.info(
            "phase=%d/2, iter=%d, dim,nc,csz=%d,%d,%d, loss_per_iter=%s, "
            "logprob_loss=%.3f, logits_entropy_loss=%.3f, index_entropy_loss=%.3f",
            phase, i, self.config.dim, self.config.num_codebooks, self.config.codebook_size,
            ["%.3f" % v for v in det], float(losses.logprob_loss),
            float(losses.logits_entropy_loss), float(losses.index_entropy_loss))

    def _log_correlations(self) -> None:
        corr = core.codebook_correlations(self._whole_params(), self.config)
        if self._lead:
            logger.info("correlations = %s", corr.cpu().numpy())

    # ----------------------------------------------------------- checkpoint

    def _state_leaves(self) -> List[np.ndarray]:
        """The JAX trainer's ``tree_flatten((params, opt_state))`` leaves:
        the five parameters, the Adam count (int32), then its first and
        second moments in parameter order, whole under a mesh (a
        collective)."""
        tensors = [getattr(self.params, f) for f in PARAM_FIELDS]
        leaves = [self._whole(f, t.detach()).cpu().numpy() for f, t in zip(PARAM_FIELDS, tensors)]
        states = [self.opt.state.get(t, {}) for t in tensors]
        count = int(states[0]["step"]) if states[0] else 0
        leaves.append(np.asarray(count, np.int32))
        for key in ("exp_avg", "exp_avg_sq"):
            leaves += [self._whole(f, s[key] if s else torch.zeros_like(t)).cpu().numpy()
                       for f, s, t in zip(PARAM_FIELDS, states, tensors)]
        return leaves

    def _load_state_leaves(self, leaves: List[np.ndarray]) -> None:
        if len(leaves) != N_LEAVES:
            raise ValueError(f"expected {N_LEAVES} checkpoint leaves, got {len(leaves)}")
        n = len(PARAM_FIELDS)
        params = params_from_numpy(dict(zip(PARAM_FIELDS, leaves[:n])), self.device)
        self._set_params(self._shard(params))
        count = int(leaves[n])

        def moment(leaf, f):
            m = torch.from_numpy(np.array(leaf, np.float32)).reshape(getattr(params, f).shape)
            return self._part(f, m.to(self.device))

        for i, f in enumerate(PARAM_FIELDS):
            self.opt.state[getattr(self.params, f)] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moment(leaves[n + 1 + i], f),
                "exp_avg_sq": moment(leaves[2 * n + 1 + i], f),
            }

    def save_checkpoint(self, path) -> None:
        """Full mid-phase resume state (parameters, Adam moments, counters,
        host RNG) in the JAX trainer's format.  Under a mesh every rank
        calls it, the state is gathered whole, and rank 0 writes."""
        state = self._rng.bit_generator.state["state"]
        meta = dict(
            dim=self.config.dim,
            codebook_size=self.config.codebook_size,
            num_codebooks=self.config.num_codebooks,
            cur_iter=self.cur_iter,
            lr=self.lr,
            phase_one_iters=self.phase_one_iters,
            phase_two_iters=self.phase_two_iters,
            two_iter_prob=self.two_iter_prob,
            entropy_scale=self.entropy_scale,
            train_search=self.train_search,
            beam_finetune_iters=self.beam_finetune_iters,
            rng_state=state["state"],
            rng_inc=state["inc"],
        )
        leaves = self._state_leaves()
        if self._lead:
            buf = io.BytesIO()
            np.savez(buf, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                     **{f"leaf_{i}": v for i, v in enumerate(leaves)})
            with open(path, "wb") as f:
                f.write(buf.getvalue())
        if self.mesh is not None:
            self.mesh.barrier()  # the file is whole before any rank reads it

    @classmethod
    def load_checkpoint(cls, path, **kwargs) -> "QuantizerTrainer":
        """A trainer resumed from a checkpoint written by
        :meth:`save_checkpoint` or by the JAX package's
        ``QuantizerTrainer.save_checkpoint``.  The search routing is restored
        from the checkpoint unless ``kwargs`` override it; pass ``device``
        or ``mesh`` as for the constructor (under a mesh every rank calls
        it, and each takes its slices)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            n = sum(1 for k in z.files if k.startswith("leaf_"))
            leaves = [z[f"leaf_{i}"] for i in range(n)]
        bytes_per_frame = (meta["num_codebooks"] // 2 if meta["codebook_size"] == 16
                           else meta["num_codebooks"])
        for k in ("train_search", "beam_finetune_iters"):
            if k in meta:
                kwargs.setdefault(k, meta[k])
        self = cls(
            meta["dim"], bytes_per_frame,
            phase_one_iters=meta["phase_one_iters"],
            phase_two_iters=meta["phase_two_iters"],
            lr=meta["lr"],
            two_iter_prob=meta["two_iter_prob"],
            entropy_scale=meta["entropy_scale"],
            **kwargs,
        )
        self.config = QuantizerConfig(dim=meta["dim"], codebook_size=meta["codebook_size"],
                                      num_codebooks=meta["num_codebooks"])
        self._load_state_leaves(leaves)
        self.cur_iter = meta["cur_iter"]
        state = self._rng.bit_generator.state
        state["state"]["state"] = meta["rng_state"]
        state["state"]["inc"] = meta["rng_inc"]
        self._rng.bit_generator.state = state
        return self
