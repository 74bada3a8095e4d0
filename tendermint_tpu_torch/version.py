"""Version info (ref version/version.go:21; the port's copy of the
reference package's ``version.py``): the semver and the protocol versions,
the same numbers, so that nodes of either package agree on them."""

__version__ = "0.1.0"

# protocol versions, bumped on incompatible changes (ref version/version.go:36-44)
BLOCK_PROTOCOL = 1
P2P_PROTOCOL = 1
APP_INTERFACE_VERSION = 1
