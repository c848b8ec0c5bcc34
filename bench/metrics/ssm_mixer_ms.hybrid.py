"""Device ms an update launched under the runner's span ``ssm_mixer``
(each call of the program's Mamba-2 mixer, ``models/ssm.ssm_block``):
the mixers' forwards and their checkpoint recomputes; their backward
runs under the grad spans."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["ssm_mixer"], "updates")
