"""Node identity key (ref p2p/key.go), the port's copy of the reference
package's ``p2p/key.py``, over the port's ``PrivKeyEd25519``.

ID = hex of the ed25519 pubkey address; persisted as JSON."""

from __future__ import annotations

import base64
import json
import os

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519


class NodeKey:
    def __init__(self, priv_key: PrivKeyEd25519):
        self.priv_key = priv_key

    def pub_key(self):
        return self.priv_key.pub_key()

    def id(self) -> str:
        """p2p.ID — hex address of the node pubkey (key.go PubKeyToID)."""
        return self.pub_key().address().hex()

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "priv_key": {
                        "type": "ed25519",
                        "value": base64.b64encode(self.priv_key.bytes()).decode(),
                    }
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            obj = json.load(f)
        return cls(PrivKeyEd25519(base64.b64decode(obj["priv_key"]["value"])))

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls(PrivKeyEd25519.generate())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        nk.save_as(path)
        return nk
