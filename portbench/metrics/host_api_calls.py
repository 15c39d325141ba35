"""host_api_calls (calls; dispatch): the host's CUDA runtime and driver
API calls inside one dispatch's span, from the traced dispatches."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return ctx.trace.api_calls_per_dispatch
