"""Light-client verification frontend (the port's copy of the reference
package's ``frontend/``): one process anchors any number of thin clients,
folds their concurrent bisection and commit-verify requests into shared
``parallel/planner.LaneFeed`` dispatches, dedups per-height work (cache and
single flight), and serves the result over the ``lite/proxy`` HTTP surface.
"""

from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.frontend.cache import HeaderCache, SingleFlight
from tendermint_tpu_torch.frontend.frontend import LiteFrontend

__all__ = [
    "BatchingVerifier",
    "HeaderCache",
    "LiteFrontend",
    "SingleFlight",
]
