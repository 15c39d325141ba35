"""peak_mem_gib (GiB; memory planning): the device memory the program
holds over the window: the caching allocator's reserved peak
(torch.cuda.max_memory_reserved after reset_peak_memory_stats). A CUDA
graph's activations live in its private pool, reserved at capture and
never allocated again by a replay, so the allocated peak would leave
them out."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2 ** 30
