"""The benchmark's span around the program's scene build
(``SceneBuilder.build``: the host BVH build, the tables' upload)."""


def read(run):
    t = run.spans.times.get("scene_build")
    return t[0] if t else None
