from cuopt_torch.distance_engine.waypoint_matrix import WaypointMatrix

__all__ = ["WaypointMatrix"]
