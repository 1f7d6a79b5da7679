"""DiffMM's multi-phase trainer, serving half (counterpart of
``genmmrec_tpu/engine/diffusion_trainers.py`` ``DiffMMTrainer``).

``regenerate`` is phase 2 of a DiffMM epoch: reverse-diffuse every user's
interaction vector through each modality's denoiser, take the top
``rebuild_k`` items (K3) and rebuild the two modal user-item graphs. The
denoiser training of phase 1 and the BPR/InfoNCE epoch come with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from genmmrec_tpu_torch.engine.trainer import Trainer, full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk


class DiffMMTrainer(Trainer):
    @torch.no_grad()
    def regenerate(self, generator: Optional[torch.Generator] = None) -> dict:
        """Rebuild ``self.state``'s modal graphs from the current denoisers.

        Users go in ``train_batch_size`` chunks; the last chunk is padded
        with the last user, so every chunk has the same shape, as in the
        JAX package. ``generator`` draws the edge dropout when
        ``keep_rate < 1`` and the sampling noise when it is on.
        """
        full_precision_matmuls()
        model = self.model
        U, B = model.n_users, self.train_batch_size
        n_chunks = -(-U // B)
        users = torch.arange(n_chunks * B, device=model.device).clamp_(max=U - 1)

        def topk_for(denoiser):
            idx = []
            for lo in range(0, n_chunks * B, B):
                x_start = model.interaction_vectors(users[lo : lo + B])
                denoised = model.p_sample_users(denoiser, x_start, generator)
                idx.append(grouped_topk(denoised, model.rebuild_k)[1])
            return torch.cat(idx)[:U]

        self.state = {
            **self.state,
            "image_ui": model.rebuild_ui_graph(topk_for(model.denoise_image), generator),
            "text_ui": model.rebuild_ui_graph(topk_for(model.denoise_text), generator),
        }
        return self.state
