"""DiffRec: diffusion over each user's interaction vector (counterpart of
``genmmrec_tpu/models/diffrec.py``).

A DDPM over the dense (n_items,) history row of each user, denoised by the
x0-predicting ``Denoise`` MLP; the loss is the per-row MSE, SNR-weighted
with importance-sampled timesteps over the loss-history state
(``diffusion/importance.py``) when ``reweight``; the scores are the full
reverse chain (all ``steps``) from the history row, re-noised by
``sampling_steps`` first when that is not 0. The loss's draws (timesteps,
noise, the denoiser's input dropout) can be passed to ``loss``.

Parameters: ``{"dnn": {emb_layer, in_layers, out_layers}}`` as in the JAX
package.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.importance import init_lt_state, sample_timesteps, update_lt_state
from genmmrec_tpu_torch.models.diffusion.sampler import p_sample_loop
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_sample, snr


class DiffRec(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.steps = scalar(config["steps"], int)
        self.noise_scale = scalar(config["noise_scale"])
        self.dropout = scalar(config["dropout"])
        self.reweight = bool(config["reweight"])
        self.sampling_steps = scalar(config["sampling_steps"] or 0, int)
        self.emb_size = scalar(config["embedding_size"], int)
        dims = config["dims"] if isinstance(config["dims"], list) else [config["dims"]]
        out_dims = list(dims) + [self.n_items]
        self.sched = make_schedule(
            str(config["noise_schedule"]), self.noise_scale, scalar(config["noise_min"]),
            scalar(config["noise_max"]), self.steps, device=self.device,
        )
        self.dnn = Denoise(out_dims[::-1], out_dims, self.emb_size).to(self.device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.dnn.init_params(generator)

    def init_state(self, generator=None) -> dict:
        return init_lt_state(self.steps, device=self.device)

    def _diffusion_loss(self, state, users, weight, generator=None, ts=None, noise=None, keep=None, rows=None):
        """Over a data axis (``rows``) the draws (given or made) are the
        global batch's and this rank takes its rows of them; the state
        records every rank's rows, and the loss is this rank's share."""
        x_start = interaction_vectors(self.data, users)
        B = x_start.shape[0] if rows is None else rows.n
        method = "importance" if self.reweight else "uniform"
        ts, pt = sample_timesteps(state, B, method, generator=generator, t=ts)
        shape = (B, self.n_items)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=x_start.device)
        if rows is not None:
            if keep is None and self.dropout > 0.0:
                keep = torch.rand(shape, generator=generator, device=x_start.device) < 1.0 - self.dropout
            ts, pt, noise = rows.local((ts, pt, noise))
            keep = None if keep is None else rows.local(keep)
        x_t = q_sample(self.sched, x_start, ts, noise) if self.noise_scale != 0 else x_start
        out = self.dnn(x_t, ts, dropout=self.dropout, keep=keep, generator=generator)
        mse = ((x_start - out) ** 2).mean(dim=1)
        if self.reweight:
            w = torch.where(ts == 0, 1.0, snr(self.sched, ts - 1) - snr(self.sched, ts))
        else:
            w = torch.ones(ts.shape[0], device=x_start.device)
        losses = w * mse
        if rows is None:
            new_state = update_lt_state(state, ts, losses, weight) if self.reweight else state
            return (losses / pt * weight).sum() / weight.sum().clamp(min=1.0), new_state
        if self.reweight:
            gathered = (rows.gather(t.detach()) for t in (ts, losses, weight))
            state = update_lt_state(state, *gathered)
        return (losses / pt * weight).sum() / rows.count(weight.sum()).clamp(min=1.0), state

    def loss_and_update(self, state, batch, generator=None, ts=None, noise=None, keep=None):
        """The loss and the state with the batch's losses recorded. ``ts``
        (B,), ``noise`` and ``keep`` (B, n_items) replace the draws."""
        total, new_state = self._diffusion_loss(
            state, batch["users"], batch["weight"], generator, ts, noise, keep, batch.get("rows")
        )
        return total, ((total,), new_state)

    def loss(self, state, batch, generator=None, ts=None, noise=None, keep=None):
        total, _ = self._diffusion_loss(
            state, batch["users"], batch["weight"], generator, ts, noise, keep, batch.get("rows")
        )
        return total, (total,)

    def scores(self, state, users) -> torch.Tensor:
        """The reverse chain from the users' history rows; the re-noising of
        ``sampling_steps`` > 0 draws from a generator seeded 0 (the JAX
        package's fixed key, with torch's numbers)."""
        x_start = interaction_vectors(self.data, users)
        gen = torch.Generator(device=x_start.device).manual_seed(0) if self.sampling_steps > 0 else None
        return p_sample_loop(self.sched, self.dnn, x_start, self.sampling_steps, gen)
