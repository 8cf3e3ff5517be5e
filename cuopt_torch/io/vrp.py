"""VRP benchmark-instance IO: Solomon/Gehring-Homberger CVRPTW and
CVRPLIB .vrp (CVRP) formats.

The reference's routing quality gate reads Gehring-Homberger CVRPTW and
CVRP Vrp-Set-X instances and compares against best-known solutions
(cpp/tests/routing/l2_routing_test.cu:33-53; instance lists
datasets/ref/{homberger.txt,cvrp.txt}, BKS table
datasets/ref/bks_gehring_homberger.csv). This module parses both formats
into routing DataModels, and can also WRITE Solomon format so synthetic
GH-class fixtures live in-repo for offline regression (the published
instances themselves are network downloads, datasets/get_test_data.sh).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class VrpInstance:
    name: str
    xy: np.ndarray          # (n_nodes, 2) incl. depot at index 0
    demand: np.ndarray      # (n_nodes,) depot 0
    capacity: float
    n_vehicles: int
    # CVRPTW only (None for plain CVRP)
    tw_early: np.ndarray | None = None
    tw_late: np.ndarray | None = None
    service: np.ndarray | None = None
    # distance rounding convention: "exact" (GH CVRPTW, euclidean
    # doubles) or "round" (CVRPLIB EUC_2D, nearest integer)
    edge_weights: str = "exact"
    meta: dict = field(default_factory=dict)

    @property
    def n_customers(self) -> int:
        return len(self.xy) - 1

    def cost_matrix(self) -> np.ndarray:
        d = np.sqrt(
            ((self.xy[:, None, :] - self.xy[None, :, :]) ** 2).sum(-1)
        )
        if self.edge_weights == "round":
            d = np.rint(d)
        return d

    def to_data_model(self, n_vehicles: int | None = None):
        """Build a routing DataModel (cuopt_torch.routing.DataModel)."""
        from cuopt_torch.routing.data_model import DataModel

        nv = int(n_vehicles or self.n_vehicles)
        n = len(self.xy)
        dm = DataModel(n, nv, self.n_customers)
        dist = self.cost_matrix()
        dm.add_cost_matrix(dist)
        locs = np.arange(1, n, dtype=np.int32)
        dm.set_order_locations(locs)
        cap = np.full(nv, self.capacity)
        dm.add_capacity_dimension("demand",
                                  self.demand[1:].astype(np.float64), cap)
        if self.tw_early is not None:
            dm.add_transit_time_matrix(dist)
            dm.set_order_time_windows(self.tw_early[1:], self.tw_late[1:])
            dm.set_order_service_times(self.service[1:])
            dm.set_vehicle_time_windows(
                np.full(nv, self.tw_early[0]), np.full(nv, self.tw_late[0])
            )
        return dm


def parse_solomon(text: str, name: str = "") -> VrpInstance:
    """Solomon / Gehring-Homberger CVRPTW format (VEHICLE + CUSTOMER
    sections; customer 0 is the depot)."""
    lines = [ln.strip() for ln in text.splitlines()]
    if not name:
        for ln in lines:
            if ln:
                name = ln.split()[0]
                break
    nv = cap = None
    rows = []
    mode = None
    for ln in lines:
        up = ln.upper()
        if up.startswith("VEHICLE"):
            mode = "vehicle"
            continue
        if up.startswith("CUSTOMER"):
            mode = "customer"
            continue
        if not ln:
            continue
        toks = ln.split()
        if mode == "vehicle" and len(toks) == 2 and \
                toks[0].lstrip("-").isdigit():
            nv, cap = int(toks[0]), float(toks[1])
        elif mode == "customer" and len(toks) >= 7 and \
                toks[0].lstrip("-").isdigit():
            rows.append([float(t) for t in toks[:7]])
    if nv is None or not rows:
        raise ValueError(f"not a Solomon-format instance: {name!r}")
    arr = np.asarray(rows)
    order = np.argsort(arr[:, 0])
    arr = arr[order]
    return VrpInstance(
        name=name,
        xy=arr[:, 1:3].copy(),
        demand=arr[:, 3].copy(),
        capacity=float(cap),
        n_vehicles=int(nv),
        tw_early=arr[:, 4].copy(),
        tw_late=arr[:, 5].copy(),
        service=arr[:, 6].copy(),
        edge_weights="exact",
    )


def write_solomon(inst: VrpInstance) -> str:
    """Serialize a CVRPTW instance in Solomon format (round-trippable
    through parse_solomon)."""
    out = [inst.name, "", "VEHICLE", "NUMBER     CAPACITY",
           f"  {inst.n_vehicles}        {inst.capacity:g}", "", "CUSTOMER",
           "CUST NO.  XCOORD.   YCOORD.    DEMAND   READY TIME  "
           "DUE DATE   SERVICE TIME", ""]
    for i in range(len(inst.xy)):
        out.append(
            f"{i:>5} {inst.xy[i, 0]:>10.3f} {inst.xy[i, 1]:>10.3f} "
            f"{inst.demand[i]:>9.3f} {inst.tw_early[i]:>11.3f} "
            f"{inst.tw_late[i]:>10.3f} {inst.service[i]:>13.3f}"
        )
    return "\n".join(out) + "\n"


def parse_cvrplib(text: str, name: str = "") -> VrpInstance:
    """CVRPLIB .vrp format (NODE_COORD/DEMAND/DEPOT sections,
    EDGE_WEIGHT_TYPE EUC_2D)."""
    header = {}
    coord, dem = {}, {}
    depot = 1
    mode = None
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln == "EOF":
            continue
        m = re.match(r"^([A-Z_]+)\s*:\s*(.*)$", ln)
        if m:
            header[m.group(1)] = m.group(2).strip()
            mode = None
            continue
        if ln in ("NODE_COORD_SECTION", "DEMAND_SECTION",
                  "DEPOT_SECTION"):
            mode = ln
            continue
        toks = ln.split()
        if mode == "NODE_COORD_SECTION" and len(toks) >= 3:
            coord[int(toks[0])] = (float(toks[1]), float(toks[2]))
        elif mode == "DEMAND_SECTION" and len(toks) >= 2:
            dem[int(toks[0])] = float(toks[1])
        elif mode == "DEPOT_SECTION" and toks[0] != "-1":
            depot = int(toks[0])
    n = int(header.get("DIMENSION", len(coord)))
    if not name:
        name = header.get("NAME", "cvrp")
    ids = sorted(coord)
    assert len(ids) == n, (len(ids), n)
    # reorder so the depot is node 0
    ids = [depot] + [i for i in ids if i != depot]
    xy = np.asarray([coord[i] for i in ids])
    demand = np.asarray([dem.get(i, 0.0) for i in ids])
    # vehicle count from the canonical X-nXXX-kYY name when present
    m = re.search(r"k(\d+)", name)
    nv = int(m.group(1)) if m else max(
        1, math.ceil(demand.sum() / float(header.get("CAPACITY", 1)))
    )
    return VrpInstance(
        name=name,
        xy=xy,
        demand=demand,
        capacity=float(header.get("CAPACITY", np.inf)),
        n_vehicles=nv,
        edge_weights="round"
        if header.get("EDGE_WEIGHT_TYPE", "EUC_2D") == "EUC_2D"
        else "exact",
        meta=header,
    )


def parse_instance_file(path: str) -> VrpInstance:
    text = open(path).read()
    if "NODE_COORD_SECTION" in text:
        return parse_cvrplib(text)
    return parse_solomon(text)


def load_bks_table(path: str) -> dict[str, tuple[int, float]]:
    """datasets/ref/bks_gehring_homberger.csv ->
    {instance: (vehicles, cost)}; also accepts the homberger.txt /
    cvrp.txt pointer lists (path,cost,vehicles)."""
    table = {}
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.lower().startswith("instance"):
            continue
        toks = ln.split(",")
        if len(toks) != 3:
            continue
        base = toks[0].split("/")[-1]
        a, b = float(toks[1]), float(toks[2])
        # csv column order is (vehicles, cost); pointer lists use
        # (cost, vehicles) — vehicles is the small integer
        if a <= b:
            veh, cost = a, b
        else:
            veh, cost = b, a
        table[base] = (int(veh), float(cost))
    return table


# ------------------------------------------------- GH-class synthesis
def synth_gh_instance(n_customers: int, kind: str = "C", seed: int = 0,
                      horizon: float = 1000.0, capacity: float = 200.0,
                      tw_frac: float = 0.5) -> VrpInstance:
    """Synthesize a Gehring-Homberger-CLASS CVRPTW instance: customers
    clustered (C), random (R) or mixed (RC) on a 100x100-ish grid scaled
    with n, demands 1-40, a share of customers with tight time windows.
    Used for the offline quality regression (the real GH files are
    downloads; datasets/get_test_data.sh)."""
    rng = np.random.default_rng(seed)
    span = 100.0 * math.sqrt(max(n_customers, 100) / 100.0)
    pts = []
    if kind in ("C", "RC"):
        n_cl = max(3, n_customers // 25)
        centers = rng.uniform(5, span - 5, (n_cl, 2))
        n_clustered = n_customers if kind == "C" else n_customers // 2
        for i in range(n_clustered):
            c = centers[rng.integers(n_cl)]
            pts.append(c + rng.normal(0, 3.0, 2))
    n_rand = n_customers - len(pts)
    for _ in range(n_rand):
        pts.append(rng.uniform(0, span, 2))
    xy = np.vstack([[[span / 2, span / 2]], np.clip(pts, 0, span)])
    demand = np.concatenate([[0], rng.integers(1, 41, n_customers)])
    service = np.concatenate([[0.0], np.full(n_customers, 10.0)])
    depot_d = np.sqrt(((xy - xy[0]) ** 2).sum(1))
    tw_early = np.zeros(n_customers + 1)
    tw_late = np.full(n_customers + 1, horizon)
    tight = rng.random(n_customers + 1) < tw_frac
    tight[0] = False
    for i in range(1, n_customers + 1):
        if tight[i]:
            lo = depot_d[i]
            hi = horizon - depot_d[i] - service[i]
            if hi <= lo:
                continue
            center = rng.uniform(lo, hi)
            width = rng.uniform(30.0, 120.0)
            tw_early[i] = max(lo, center - width / 2)
            tw_late[i] = min(hi, center + width / 2)
    nv = max(2, math.ceil(demand.sum() / capacity) + 2)
    return VrpInstance(
        name=f"GH{kind}_{n_customers}_{seed}",
        xy=xy, demand=demand.astype(float), capacity=capacity,
        n_vehicles=nv, tw_early=tw_early, tw_late=tw_late,
        service=service, edge_weights="exact",
    )


def solution_cost(inst: VrpInstance, assignment) -> tuple[float, int]:
    """(total distance, vehicles used) of a solve result under the
    instance's distance convention — the quantity BKS tables score."""
    table = assignment.get_route()
    dist = inst.cost_matrix()
    total = 0.0
    used = 0
    truck = table["truck_id"]
    for v in np.unique(truck):
        grp = table[truck == v]
        order = np.argsort(grp["arrival_stamp"], kind="stable")
        seq = [int(x) for x in grp["location"][order]]
        if len(seq) <= 2:
            continue
        used += 1
        total += float(sum(dist[a, b] for a, b in zip(seq, seq[1:])))
    return total, used
