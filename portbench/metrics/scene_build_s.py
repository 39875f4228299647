"""Seconds the program's scene builder took in set-up, on the harness's
clock (scenes.py:program_scene: OBJ or recipe to a Scene on the card,
its BVH and env cache included)."""


def read(ctx):
    return ctx.scene_build_s
