"""Acceleration structures: the BVH build's front end (accel/bvh.py)."""
