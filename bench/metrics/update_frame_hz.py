"""Paper Table 2's network update frame rate: updates completed in the
window times the batch, over the window's wall, which ends in a
synchronise (``TrainHistory.update_frame_hz`` of the port's own
``train()``)."""


def read(ctx):
    return ctx.window.get("update_frame_hz")
