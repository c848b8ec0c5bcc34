"""Tokens through the RL learner: updates completed in the window times
batch times sequence, over the window's wall, which ends in a
synchronise."""


def read(ctx):
    return ctx.window.get("update_tokens_per_s")
