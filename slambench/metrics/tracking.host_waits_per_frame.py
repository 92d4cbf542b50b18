"""Host reads of device values (``utils.torch_ops.host_fetch_count``, the
port's counter) per frame of the traced run's untraced stretch, the
server's keyframe work included."""


def read(ctx):
    return ctx.get("host_waits_per_frame")
