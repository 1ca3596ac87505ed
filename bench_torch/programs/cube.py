"""The program's closed box from a configuration file: the port's
``CubeConfig`` with the file's box and particle count."""


def config(amt, cfg: dict, eng):
    return amt.CubeConfig(geometry=amt.CubeGeometry(**cfg["box"]),
                          nmft=cfg["nmft"],
                          steps_per_mft=cfg["steps_per_mft"], engine=eng,
                          num_particles_override=cfg.get("num_particles"))
