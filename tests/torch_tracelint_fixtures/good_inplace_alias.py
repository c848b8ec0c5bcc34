"""inplace-alias control: the consumers own copies."""
import threading

import torch

from repro_torch._tree import tree_map
from repro_torch.analysis.hlolint.contract import EntrypointContract

HLOLINT_CONTRACTS = (
    EntrypointContract(name="step", module=__name__, inplace=True,
                       state=("state", "replay")),
)


class Trainer:
    def publish(self, q, pool):
        q.put(tree_map(torch.clone, self.state.actor))
        pool.submit(print, self._clone_actor())
        threading.Thread(target=print,
                         args=(self.replay.ptr.clone(),)).start()
        q.put(self.total_frames)
