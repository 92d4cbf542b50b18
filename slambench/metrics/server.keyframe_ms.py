"""Host milliseconds of ``server.process_new_keyframes`` per keyframe it
took (each agent's loop closing, the keyframe database, the fusion
detection, a fusion where one happens), in the traced run's untraced
stretch."""


def read(ctx):
    return ctx.get("keyframe_ms")
