"""shakti_tpu: a JAX subglacial hydrology FEM framework.

From-scratch JAX/XLA re-design with the capabilities of the SHAKTI
reference implementation (agstub/shakti-fenics): P1 unstructured-triangle
finite elements, matrix-free Newton-Krylov effective-pressure solves, fused
explicit gap-height evolution, SPMD domain decomposition over device
meshes (GPUs, or virtual CPU devices in the tests), and the surrounding
runtime (setup/data adapters, IO, checkpointing, CLI).

Layer map (mirrors SURVEY.md §1 of the reference):
  mesh/      host-side meshing, partitioning, boundary topology; device Mesh
  fem/       P1 element core: quadrature, gather/scatter, averaging
  physics/   SHAKTI constitutive laws + weak-form residual (pure jnp)
  solve/     Newton + Krylov + scanned time loop (all one XLA program)
  parallel/  shard_map SPMD over jax device meshes
  api/       model_setup-equivalent experiment API
  io/        results/history/checkpoint-resume
  data/      gridded-dataset adapters (bilinear interp, lake outlines)
"""

__version__ = "0.1.0"

from shakti_tpu.params import PhysicalParams, DEFAULT_PARAMS  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (avoids importing jax at package import):

    ModelSetup, solve, solve_steady, NewtonConfig, rectangle_mesh,
    polygon_mesh, read_msh, post (module)."""
    import importlib

    lazy = {
        "ModelSetup": ("shakti_tpu.api.model", "ModelSetup"),
        "solve": ("shakti_tpu.api.run", "solve"),
        "solve_steady": ("shakti_tpu.api.steady", "solve_steady"),
        "NewtonConfig": ("shakti_tpu.solve.newton", "NewtonConfig"),
        "rectangle_mesh": ("shakti_tpu.mesh.generate", "rectangle_mesh"),
        "polygon_mesh": ("shakti_tpu.mesh.generate", "polygon_mesh"),
        "read_msh": ("shakti_tpu.mesh.msh_io", "read_msh"),
        "post": ("shakti_tpu.post", None),
    }
    if name in lazy:
        mod, attr = lazy[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'shakti_tpu' has no attribute {name!r}")
