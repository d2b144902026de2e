"""The networked replica node (net/peer.py) and its message codecs
(net/framing.py)."""
