"""Render configuration.

``RenderConfig`` keeps the field names and defaults of the JAX package's
(``ray_tracer_tpu/config.py``), so one configuration reads the same in
both, except ``max_rays_per_batch``, whose JAX default is a TPU memory
ceiling.  ``Routing`` keeps only what this package reads: the coherence-bin
key widths and flavour (``bin_bits``, ``bin_dir_bits``, ``bin_mode``), the
pre-permute NEE switch ``nee_prebin``, and the traversal-route switches
(``wide``, ``groups``, ``anyhit_group``, ``cluster``, ``cluster_k``,
``cluster_enum``, ``lanewalk``, ``two_phase``, ``top_k``).  The TPU placement and
packet-shape knobs (``packet``, ``packet_size``, ``vmem_budget``,
``mask_mode``, ``multi_pop``, ``groups_packet``, ``anyhit_groups``,
``cluster_enum_packet``) have no counterpart here: every route runs its
hand-written CUDA kernels one thread per ray.

``routing=None`` resolves through :meth:`Routing.from_env` when a frame is
traced, as in the JAX package: each of the 13 fields reads its ``RT_*``
variable with the JAX package's parse, and an unset variable leaves the
field's default.  An explicit ``Routing`` reads no environment.

The JAX package's other ``RT_*`` variables, and what this package does
with each:

* ``RT_SBVH``: read by ``SceneBuilder.compile(spatial_splits=None)``, as
  the JAX builder reads it (``"0"`` builds without spatial splits).
* ``RT_ASSETS``: the asset directory of the presets
  (``scene/presets.py::DEFAULT_ASSETS``; default ``assets/`` at the
  repository root).
* ``RT_BENCH_WIDTH``, ``_HEIGHT``, ``_SPP``, ``_SCENE``, ``_TILE_LOG2``,
  ``_CPU``: the bench's knobs (``bench.py``).
* Not read, because they exist only for the TPU: ``RT_PACKET``,
  ``RT_PACKET_SIZE``, ``RT_PACKET_VMEM_BUDGET``, ``RT_MULTI_POP``,
  ``RT_MASK_MODE``, ``RT_GROUPS_PACKET``, ``RT_ANYHIT_GROUPS``,
  ``RT_CLUSTER_ENUM_PACKET`` (the ``Routing`` fields above without a
  counterpart), and ``RT_GROUP_REGTOP``, ``RT_ABLATE``,
  ``RT_ANYHIT_NEARFIRST``, ``RT_ANYHIT_ORDERFREE_PACKET``,
  ``RT_SCOPED_VMEM_KIB`` (switches inside the Pallas kernels and their
  compiler options).
* Not read, because the port has one way of doing it: ``RT_CACHE``,
  ``RT_NATIVE_BVH`` and ``RT_NATIVE_OBJ`` (the C++ builders are always
  used, built into the checkout's ``build/``, and a failed build raises),
  and ``RT_ROPE_BUILD`` (the rope streams are built only on
  ``compile(rope_streams=True)``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class Routing:
    # Coherence-binning key widths: morton bits per origin axis, and extra
    # |direction| bits inside the octant.
    bin_bits: int = 6
    bin_dir_bits: int = 0
    # Bounce-round key flavour: "morton" (octant, origin morton cell);
    # "leaf" (octant, previous-hit primitive; camera lanes by pixel id);
    # "hier" (morton cells, lanes inside a cell by previous-hit
    # primitive: two stable argsorts).  Each is a pure re-permutation of
    # the lanes: the image is bit-identical.
    bin_mode: str = "morton"
    # Pre-permute NEE (occlusion NEE only): "off" traces the shadow rays
    # after the state permute; "nosort" traces and resolves them before
    # it, in the lanes' order, and "sort" in the order of their own bin
    # key.  The permute then carries the resolved ``direct`` instead of
    # the NEE inputs.  Bit-identical to "off".
    nee_prebin: str = "off"
    # BVH8 routes (True) or the narrow route (False): closest hit through
    # the binary-BVH walk (kernels/packet.py::packet_traverse), occlusion
    # as that closest hit clipped at tmax.
    wide: bool = True
    # Closest-hit triangle traversal through the group kernel
    # (kernels/group.py) when > 0; 0 routes it through the packet walk
    # (kernels/packet.py).  The count itself is a TPU lane-group shape and
    # is not read.  Scenes with 16-record leaf slots always take the walk.
    # On one-row slots both wrappers launch the same CUDA walk
    # (csrc/bvh8_walk.cu): the switch, kept for the JAX package's routing
    # names, picks the wrapper and so the launch counter.
    groups: int = 16
    # Occlusion through the group kernel too (else the packet walk).
    anyhit_group: bool = True
    # Cluster route (ops/cluster_trace.py): "on" routes closest-hit and
    # occlusion through candidate enumeration + per-cluster triangle tests
    # on scenes compiled with cluster tables; "auto" and "off" never do
    # (the JAX package measured "auto" as off).  Unlike the JAX package's
    # ``use_cluster`` there is no bound on the enumeration tree's size:
    # that bound is the TPU's scalar-memory capacity.
    cluster: str = "auto"
    # Per-lane candidate-cluster slots; lanes with more candidates fall
    # back to the packet walk.
    cluster_k: int = 16
    # Candidate enumeration: "packet" (emit-mode walk over the cluster
    # BVH8) or "boxes" (two brute-force slab-test levels over the super
    # and cluster boxes; needs the scene's super tables).
    cluster_enum: str = "packet"
    # Rope-walk route (kernels/lanewalk.py): "force" routes closest hit and
    # occlusion through the per-octant rope streams, ahead of every other
    # route, on a scene compiled with ``rope_streams=True`` (else it
    # raises).  "auto" and "off" never do; "interpret" is the JAX
    # package's Pallas interpreter and raises here.
    lanewalk: str = "off"
    # Two-phase treelet traversal (ops/traverse.py::_two_phase_wide): a TOP
    # walk emits each ray's treelet entries, the (ray, entry) pairs are
    # sorted by entry and walked by DEEP launches from their entries.  On
    # a wide scene with treelets it takes closest hit and occlusion from
    # the group kernel and the packet walk.  The JAX package measured it
    # slower than one phase on the TPU (its config.py).
    two_phase: bool = False
    # Per-lane entry slots of the TOP walk; lanes with more walk the whole
    # tree from the root in the DEEP phase.
    top_k: int = 5

    def __post_init__(self):
        if self.cluster not in ("auto", "off", "on"):
            raise ValueError(f"Routing.cluster={self.cluster!r}: expected "
                             "'auto', 'off' or 'on'")
        if self.lanewalk not in ("auto", "off", "force"):
            raise ValueError(f"Routing.lanewalk={self.lanewalk!r}: expected "
                             "'auto', 'off' or 'force' ('interpret' is the "
                             "JAX package's TPU interpreter)")
        if self.bin_mode not in ("morton", "leaf", "hier"):
            raise ValueError(f"Routing.bin_mode={self.bin_mode!r}: expected "
                             "'morton', 'leaf' or 'hier'")
        if self.nee_prebin not in ("off", "sort", "nosort"):
            raise ValueError(f"Routing.nee_prebin={self.nee_prebin!r}: "
                             "expected 'off', 'sort' or 'nosort'")
        if self.cluster_enum not in ("packet", "boxes"):
            raise ValueError(f"Routing.cluster_enum={self.cluster_enum!r}: "
                             "expected 'packet' or 'boxes'")
        if self.groups < 0 or self.cluster_k < 1 or self.top_k < 1:
            raise ValueError(f"Routing: groups={self.groups} must be >= 0, "
                             f"cluster_k={self.cluster_k} and "
                             f"top_k={self.top_k} >= 1")

    @staticmethod
    def from_env() -> "Routing":
        """The default routing with the ``RT_*`` overrides of the
        environment, parsed as the JAX package's ``Routing.from_env``
        parses them; values are checked by ``__post_init__``."""
        env = os.environ.get
        return Routing(
            bin_bits=int(env("RT_BIN_BITS", 6)),
            bin_dir_bits=int(env("RT_BIN_DIR_BITS", 0)),
            bin_mode=env("RT_BIN_MODE", "morton"),
            nee_prebin=env("RT_NEE_PREBIN", "off"),
            wide=env("RT_WIDE", "1") != "0",
            groups=int(env("RT_GROUPS", 16)),
            anyhit_group=env("RT_ANYHIT_GROUP", "1") == "1",
            cluster=env("RT_CLUSTER", "auto"),
            cluster_k=int(env("RT_CLUSTER_K", 16)),
            cluster_enum=env("RT_CLUSTER_ENUM", "packet"),
            lanewalk=env("RT_LANEWALK", "off"),
            two_phase=env("RT_TWO_PHASE", "0") != "0",
            top_k=int(env("RT_TOP_K", 5)),
        )

    def replace(self, **kw) -> "Routing":
        return replace(self, **kw)


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    # Samples traced per pixel per call.
    samples_per_pixel: int = 1
    # Bounce loop runs bounce_limit + 1 times.
    bounce_limit: int = 8
    seed: int = 0
    # Russian roulette: probability 1 while ``j <= rr_start_bounce``,
    # survival clamped at rr_clamp.
    rr_start_bounce: int = 5
    rr_clamp: float = 0.95
    enable_textures: bool = True
    # Pixel-center jitter for anti-aliasing (off = the reference's corner
    # sampling).
    aa_jitter: bool = False
    # Height-map bump mapping (the shade fetch's tangent frame and 3-tap
    # height gradient) on flattened scenes with bump maps and textures;
    # forest scenes ignore it, as in the JAX package.
    enable_normal_maps: bool = False
    bump_scale: float = 1.0
    # Pixels per traversal batch: render() tiles the image into chunks of
    # this many pixels so the live wavefront state stays bounded (its lanes
    # are capped by lane_pool anyway).  2^21 holds a 1920x1080 frame in
    # one tile; the JAX package's 2^17 is its TPU memory ceiling, and on
    # the card 16 tiles of it cost a 1920x1080 frame 6.5-9.2x
    # (tools/measure_tiles.py).
    max_rays_per_batch: int = 1 << 21
    # Read by the JAX package only (its TPU watchdog split); every tile here
    # traces all of its samples in one wavefront.
    max_spp_per_dispatch: int = 32
    # Lane-pool ceiling for the spp-lane population mode (wavefront
    # trace_wave); 0 = auto (1 << 23).
    lane_pool: int = 0
    # Multi-phase drain divisor; 0 = auto (4).
    drain_div: int = 0
    # Static scan with nee_anyhit=False only: move dead lanes last before
    # the combined bounce + shadow launch (None = off).
    sort_bounce_rays: "bool | None" = None
    # NEE shadow rays as any-hit occlusion queries; False resolves them by
    # closest hit (the hit's material and the light pdf at its distance):
    # on the static scan in one launch with the bounce rays, on the
    # path-regeneration wavefront after them.
    nee_anyhit: bool = True
    # Path regeneration (integrator/wavefront.py::trace_wave); False runs
    # the static scan (wavefront.trace).
    path_regen: bool = True
    # Coherence binning of every wavefront round; None (auto) and True
    # both bin, as the kernel route always does.  False runs the rounds at
    # full width in lane order (no key, no permute, no drain): the image
    # is bit-identical.
    bin_rays: "bool | None" = None
    # Multiply specular/dielectric bounce radiance by the material albedo.
    tint_spec_diel: bool = False
    # Estimator ablation: "mis" (NEE + MIS), or "cosine" / "uniform"
    # hemisphere sampling with no NEE, which run on the static scan.
    estimator: str = "mis"
    # Traversal routing; None resolves from the RT_* variables when a frame
    # is traced (Routing.from_env), an explicit Routing is hermetic.
    routing: Optional[Routing] = None

    def resolved_routing(self) -> Routing:
        if self.routing is not None:
            return self.routing
        return Routing.from_env()

    def replace(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def wavefront(self) -> bool:
        """Does ``render`` take the path-regeneration wavefront (else the
        static scan)?  As the JAX package routes: ``path_regen`` and the
        ``"mis"`` estimator."""
        return self.path_regen and self.estimator == "mis"

    def check(self) -> None:
        """Raise ``ValueError`` for an unknown estimator."""
        if self.estimator not in ("mis", "cosine", "uniform"):
            raise ValueError(f"estimator={self.estimator!r}: expected "
                             "'mis', 'cosine' or 'uniform'")
