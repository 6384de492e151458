"""Web viewer: point clouds, ground-truth boxes and live inference in the
browser.

The port's copy of the JAX package's viewer: a standard-library
``http.server`` backend (``server.py``) and the same single-file canvas
frontend (``index.html``, no CDN assets), with the detections from the
port's network on the card.
"""
