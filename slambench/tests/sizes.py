"""The cells cut to sizes the CPU runs in seconds."""


def small_gba(cell):
    """A global-BA cell cut to a size the CPU runs in seconds."""
    cell.config["capacities"].update(max_keyframes=64, max_points=4096)
    cell.config["gba_map"].update(keyframes=[20, 24], points=3000,
                                  oversample=2.5)
    cell.traffic["distinct_maps"] = 2
    cell.params["checked_maps"] = 1
    return cell


def small_stream(cell, frames=40):
    """The stream cell at the corridor generator's 512x288 camera and small
    capacities, for the CPU."""
    c = cell.config
    c["camera"] = {"fx": 260.0, "fy": 260.0, "cx": 256.0, "cy": 144.0,
                   "bf": 31.2, "width": 512, "height": 288, "fps": 10.0}
    c["orb"]["n_features"] = 600
    c["capacities"].update(max_keyframes=64, max_points=8192,
                           max_features=1024, local_points=2048)
    c["stream"].update(z_hi=5.0, scene={"z_far": 30.0})
    cell.traffic.update(frames_per_agent=frames, checked_local_bas=1,
                        sample_from_first=1, checked_k1=2,
                        k1_sample_from_first=8)
    return cell
