"""The port's operations; its hand-written kernels count their launches."""

# the wrapper of each hand-written kernel, by module
KERNEL_WRAPPERS = {
    "segment": ("segment_spmm", "segment_spmm_backward", "segment_spmm_blocked", "segment_spmm_blocked_backward"),
    "topk": ("grouped_topk", "candidate_extract", "masked_group_max"),
    "fused_topk": ("fused_group_max", "fused_candidates", "fused_candidates_unmasked"),
}


def launch_counts() -> dict:
    """name -> how many times each hand-written kernel's wrapper has
    launched its kernel in this process (``<wrapper>.launches``; 0 for a
    wrapper that took its plain version on the CPU)."""
    import importlib

    return {
        name: int(getattr(importlib.import_module(f"genmmrec_tpu_torch.ops.{mod}"), name).launches)
        for mod, names in KERNEL_WRAPPERS.items() for name in names
    }
