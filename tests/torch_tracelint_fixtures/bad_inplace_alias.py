"""inplace-alias fixture: in-place state handed to a worker uncloned."""
import threading

from repro_torch.analysis.hlolint.contract import EntrypointContract

HLOLINT_CONTRACTS = (
    EntrypointContract(name="step", module=__name__, inplace=True,
                       state=("state", "replay")),
)


class Trainer:
    def publish(self, q, pool):
        q.put(self.state.actor)
        pool.submit(print, self.replay)
        threading.Thread(target=print, args=(self.state,)).start()
