"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the bytes K2's queries need.  A roofline share is
the least time these allow over the measured time."""

HBM_BYTES_PER_S = 3.35e12

# K2 (``lumo_bvh_closest``/``lumo_bvh_any``): each ray's origin,
# direction and t_max in (float32), and its hit out: t (float32) and prim
# (int64) for a closest query, one bool for an any query.  The BVH's
# records and the triangles it reads depend on the layout and the walk,
# so they are left out: the share is of a lower bound.
K2_RAY_IN = 3 * 4 + 3 * 4 + 4
K2_OUT = {"closest": 4 + 8, "any": 1}
K2_OPS = {"lumo_tpu_torch::bvh_closest": "closest",
          "lumo_tpu_torch::bvh_any": "any"}
K2_ORIGIN_ARG = 6           # o in the operators' schema


def k2_bytes(host_ops) -> int:
    """Bytes K2's calls among ``host_ops`` (name, start, end, shapes)
    need to move, from the operators' recorded input shapes."""
    total = 0
    for name, _, _, shapes in host_ops:
        query = K2_OPS.get(name)
        if query is not None and len(shapes) > K2_ORIGIN_ARG \
                and shapes[K2_ORIGIN_ARG]:
            total += shapes[K2_ORIGIN_ARG][0] * (K2_RAY_IN + K2_OUT[query])
    return total


def is_k2_kernel(name: str) -> bool:
    """K2's device kernel (``bvh_traverse.cu``'s ``traverse<...>``), not
    K3's ``kd_traverse``."""
    return "traverse<" in name and "kd_traverse" not in name
