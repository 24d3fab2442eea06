"""Generate a MuJoCo scene from a URDF at runtime (Hunter has no MJCF;
sim/urdf_mjcf.py counterpart, a copy).

The reference ships MJCF scenes for H1/OpenLoong/G1 but only a URDF for
Hunter (legged_hunter_description/), so its physics bringup needs a scene.
Rather than hand-author (and commit a derivative of) the reference asset,
this builds one on the fly: MuJoCo's URDF importer compiles the kinematics
and primitive collision geometry (Hunter's collisions are boxes/cylinders +
the toe/heel contact spheres; visual meshes are discarded), then the saved
MJCF is post-processed into a runnable scene:

- a freejoint on the root body (URDF import welds the base to the world);
- a ground plane + light;
- torque motors on the requested joints (ctrlrange from URDF effort limits);
- an IMU site + framequat/gyro/accelerometer sensors on the root body;
- optional inflation of the (1 mm!) URDF contact spheres to a numerically
  sane radius.

The output is cached under ~/.cache/bctpu_scenes and never committed.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET


def build_mjcf_scene_from_urdf(
    urdf_path: str,
    joint_names: list[str],
    out_path: str | None = None,
    foot_link_substr: str = "_f",
    foot_radius: float = 0.0075,
    timestep: float = 0.001,
    armature: float = 0.0,
) -> str:
    """Returns the path of the generated scene XML."""
    import mujoco

    if out_path is None:
        cache = os.path.expanduser("~/.cache/bctpu_scenes")
        os.makedirs(cache, exist_ok=True)
        out_path = os.path.join(
            cache, os.path.basename(urdf_path).replace(".urdf", "_scene.xml")
        )

    with open(urdf_path) as fh:
        urdf = fh.read()
    # effort limits per joint (URDF <limit effort=...>)
    efforts = {}
    for m in re.finditer(
        r'<joint name="([^"]+)"[^>]*>(.*?)</joint>', urdf, re.S
    ):
        lm = re.search(r'effort="([0-9.eE+-]+)"', m.group(2))
        if lm:
            efforts[m.group(1)] = float(lm.group(1))
    # inject the mujoco compiler extension as the first child of <robot>
    insert_at = urdf.index(">", urdf.index("<robot")) + 1
    urdf_mj = (
        urdf[:insert_at]
        + '\n<mujoco><compiler discardvisual="true" balanceinertia="true" '
        'strippath="true" fusestatic="false"/></mujoco>'
        + urdf[insert_at:]
    )
    model = mujoco.MjModel.from_xml_string(urdf_mj)
    tmp = out_path + ".imported"
    mujoco.mj_saveLastXML(tmp, model)

    tree = ET.parse(tmp)
    root = tree.getroot()
    # options
    opt = root.find("option")
    if opt is None:
        opt = ET.SubElement(root, "option")
    opt.set("timestep", str(timestep))
    worldbody = root.find("worldbody")
    # ground + light
    ET.SubElement(
        worldbody, "geom",
        {"name": "floor", "type": "plane", "size": "0 0 0.05",
         "friction": "1.0 0.3 0.3"},
    )
    ET.SubElement(worldbody, "light", {"pos": "0 0 2", "dir": "0 0 -1"})
    # free base + IMU site
    base = worldbody.find("body")
    assert base is not None, "URDF import produced no root body"
    ET.SubElement(base, "freejoint", {"name": "float_base"})
    ET.SubElement(base, "site", {"name": "imu", "size": "0.01", "pos": "0 0 0"})
    # Foot contact geometry must be CONSISTENT with the planner's contact
    # frames: the OCP's stance rows regulate the contact-frame origin to
    # z = 0 (positionErrorGain * p_z in the zero-velocity rows — Hunter's
    # task.info sets gain 20), so the plant must put the frame origin AT the
    # ground when standing.  Two adjustments:
    # - each contact sphere is inflated to a numerically sane radius and its
    #   center is raised by that radius, so the sphere's BOTTOM (the touch
    #   point) coincides with the frame origin;
    # - any collision geom on the foot's parent body (Hunter's sole box on
    #   leg_*5_link, which extends 4 mm BELOW the sphere bottoms) is made
    #   non-colliding — standing on the box leaves the model's contact
    #   frames permanently ~1.2 cm above ground, which the gain turns into a
    #   constant push-feet-down demand that launches the robot (measured:
    #   pitch -1.6 rad/s^2 from t=0, base z +0.21 m in 0.2 s).
    foot_parents = set()
    for body in root.iter("body"):
        for child in body.findall("body"):
            if foot_link_substr in child.get("name", ""):
                foot_parents.add(body.get("name", ""))
    for body in root.iter("body"):
        name = body.get("name", "")
        if foot_link_substr in name:
            for geom in body.findall("geom"):
                if geom.get("type", "sphere") == "sphere":
                    geom.set("size", str(foot_radius))
                    geom.set("pos", f"0 0 {foot_radius}")
                    # Explicit stiff contact: MuJoCo's default soft-constraint
                    # stiffness scales with the contacting body's inertia, and
                    # the URDF's gram-scale toe/heel links otherwise yield
                    # ~12 mm rest penetration — a soft series spring that
                    # drops the stance pitch stiffness below m*g*h and tips
                    # the robot even under a pure PD hold.
                    geom.set("solref", "0.004 1")
                    geom.set("solimp", "0.95 0.99 0.001")
                    geom.set("friction", "1.0 0.3 0.01")
        elif name in foot_parents:
            for geom in body.findall("geom"):
                geom.set("contype", "0")
                geom.set("conaffinity", "0")
    # Reflected motor inertia on the actuated joints — a per-robot CONFIG
    # knob (`simulation { jointArmature x }` in overrides.info, default 0.0
    # = trust the URDF), not a silent generator constant: Hunter's URDF
    # carries none (<dynamics damping="0.0">), so contact impacts ring the
    # gram-scale shank/foot links at 200+ rad/s single-step velocity spikes
    # — real geared actuators are dominated by rotor inertia, which damps
    # exactly this mode (measured: the spikes drive torque-clip chatter
    # that pumps the robot off the ground at lift-off).
    if armature > 0.0:
        for joint in root.iter("joint"):
            if joint.get("name") in joint_names:
                joint.set("armature", str(armature))
    # actuators
    actuators = ET.SubElement(root, "actuator")
    for j in joint_names:
        eff = efforts.get(j, 100.0)
        ET.SubElement(
            actuators, "motor",
            {"name": j, "joint": j, "ctrllimited": "true",
             "ctrlrange": f"-{eff} {eff}"},
        )
    # IMU sensors (the H1 naming scheme the backend reads)
    sensors = ET.SubElement(root, "sensor")
    ET.SubElement(sensors, "framequat", {"name": "imu_quat", "objtype": "site", "objname": "imu"})
    ET.SubElement(sensors, "gyro", {"name": "imu_gyro", "site": "imu"})
    ET.SubElement(sensors, "accelerometer", {"name": "imu_acc", "site": "imu"})

    tree.write(out_path)
    os.remove(tmp)
    return out_path
