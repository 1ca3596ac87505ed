"""The program's energized pore from a configuration file: the port's
``temperature_pore_config`` with the file's geometry, heat and scale."""


def config(amt, cfg: dict, eng):
    th = cfg["thermal"]
    pc = amt.temperature_pore_config(
        geometry=amt.PoreGeometry(**cfg["geometry"]), nmft=cfg["nmft"],
        steps_per_mft=cfg["steps_per_mft"], engine=eng, t_cold=th["t_cold"],
        t_hot=th["t_hot"], t_debye_graphene=th["t_debye_graphene"],
        t_debye_alumina=th["t_debye_alumina"],
        coated_accommodation_coeff=th["coated_accommodation"],
        gap_accommodation_coeff=th["gap_accommodation"],
        cone_half_angle_deg=th["cone_half_angle_deg"])
    if cfg.get("target_particles") is not None:
        pc = pc.scaled_to(cfg["target_particles"])
    return pc
