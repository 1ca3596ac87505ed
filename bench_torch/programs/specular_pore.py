"""The program's specular pore from a configuration file: the port's
``PoreConfig`` (``energized`` off: ``models/pore.make_pore_workload``) with
the file's geometry and dt, scaled to ``target_particles``."""


def config(amt, cfg: dict, eng):
    pc = amt.PoreConfig(geometry=amt.PoreGeometry(**cfg["geometry"]),
                        nmft=cfg["nmft"], steps_per_mft=cfg["steps_per_mft"],
                        engine=eng)
    if cfg.get("target_particles") is not None:
        pc = pc.scaled_to(cfg["target_particles"])
    return pc
