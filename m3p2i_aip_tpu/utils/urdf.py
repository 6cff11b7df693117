"""Minimal URDF kinematics loader -> jit-friendly FK chains.

The reference ships robot URDFs and leans on Isaac Gym's loader
(``actor_utils.load_asset:48-92``).  Here robots are modeled natively (see
``models/panda_fk.py``'s matrix FK), but this parser closes the asset loop:
point it at any URDF (e.g. an external franka_description checkout) and get
back a :class:`KinematicChain` whose ``fk(q)`` matches the native models —
used for validating transcribed parameters and for loading new robots
without writing FK by hand.

Only the kinematic subset of URDF is read: joint type / origin / axis /
limits and the parent-child link tree.  Rotations compose as 3x3 matrices
(dots — the fusion-friendly form; see panda_fk.py's rationale).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np


@dataclass
class Joint:
    name: str
    type: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    xyz: np.ndarray  # [3] origin translation
    rpy: np.ndarray  # [3] origin rotation (fixed)
    axis: np.ndarray  # [3]
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _axis_rotation(axis: jnp.ndarray, theta):
    """Rodrigues rotation about a (unit) axis — [..., 3, 3]."""
    ax = jnp.asarray(axis, dtype=jnp.float32)
    x, y, z = ax[0], ax[1], ax[2]
    K = jnp.asarray(
        [[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]], dtype=jnp.float32
    )
    c, s = jnp.cos(theta), jnp.sin(theta)
    eye = jnp.eye(3, dtype=jnp.float32)
    return eye * c + s * K + (1.0 - c) * jnp.outer(ax, ax)


@dataclass
class KinematicChain:
    """An ordered root->tip joint chain with jit-friendly matrix FK."""

    joints: List[Joint]
    dof_joints: List[Joint] = field(init=False)

    def __post_init__(self):
        self.dof_joints = [j for j in self.joints if j.type != "fixed"]

    @property
    def ndof(self) -> int:
        return len(self.dof_joints)

    @property
    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray([j.lower for j in self.dof_joints], dtype=np.float32)
        hi = np.asarray([j.upper for j in self.dof_joints], dtype=np.float32)
        return lo, hi

    def fk(self, q: jnp.ndarray, base_pos=None, base_rot=None) -> Dict[str, tuple]:
        """Link poses (pos [3], rot [3, 3]) for every child link in the chain."""
        pos = (
            jnp.zeros(3, dtype=jnp.float32)
            if base_pos is None
            else jnp.asarray(base_pos, dtype=jnp.float32)
        )
        rot = (
            jnp.eye(3, dtype=jnp.float32)
            if base_rot is None
            else jnp.asarray(base_rot, dtype=jnp.float32)
        )
        out: Dict[str, tuple] = {}
        qi = 0
        for j in self.joints:
            pos = pos + rot @ jnp.asarray(j.xyz)
            rot = rot @ jnp.asarray(_rpy_matrix(j.rpy))
            if j.type in ("revolute", "continuous"):
                rot = rot @ _axis_rotation(j.axis, q[qi])
                qi += 1
            elif j.type == "prismatic":
                pos = pos + rot @ (jnp.asarray(j.axis) * q[qi])
                qi += 1
            out[j.child] = (pos, rot)
        return out


def parse_urdf(path_or_string: str) -> Dict[str, Joint]:
    """All joints of a URDF, keyed by name."""
    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()
    joints: Dict[str, Joint] = {}
    for je in root.findall("joint"):
        origin = je.find("origin")
        xyz = np.fromstring(
            (origin.get("xyz", "0 0 0") if origin is not None else "0 0 0"),
            sep=" ",
            dtype=np.float32,
        )
        rpy = np.fromstring(
            (origin.get("rpy", "0 0 0") if origin is not None else "0 0 0"),
            sep=" ",
            dtype=np.float32,
        )
        axis_el = je.find("axis")
        axis = np.fromstring(
            axis_el.get("xyz", "1 0 0") if axis_el is not None else "1 0 0",
            sep=" ",
            dtype=np.float32,
        )
        limit = je.find("limit")
        joints[je.get("name")] = Joint(
            name=je.get("name"),
            type=je.get("type", "fixed"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            xyz=xyz,
            rpy=rpy,
            axis=axis / max(np.linalg.norm(axis), 1e-9),
            lower=float(limit.get("lower", 0)) if limit is not None else 0.0,
            upper=float(limit.get("upper", 0)) if limit is not None else 0.0,
            effort=float(limit.get("effort", 0)) if limit is not None else 0.0,
            velocity=float(limit.get("velocity", 0)) if limit is not None else 0.0,
        )
    return joints


def chain_to(joints: Dict[str, Joint], tip_link: str, root_link: Optional[str] = None) -> KinematicChain:
    """Extract the root->tip joint chain ending at ``tip_link``."""
    by_child = {j.child: j for j in joints.values()}
    chain: List[Joint] = []
    link = tip_link
    while link in by_child:
        j = by_child[link]
        chain.append(j)
        link = j.parent
        if root_link is not None and link == root_link:
            break
    chain.reverse()
    return KinematicChain(chain)


def load_chain(urdf_path: str, tip_link: str, root_link: Optional[str] = None) -> KinematicChain:
    return chain_to(parse_urdf(urdf_path), tip_link, root_link)
