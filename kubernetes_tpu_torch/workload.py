"""Seeded cluster and pending-pod generators for drives of the batch path:
the scheduler-throughput harness's ``plain`` and ``mixed`` workloads
(fake nodes plus a flood of pending pods, in the shape of the reference's
``test/integration/scheduler_perf``).

``plain``: four homogeneous RC-style templates.  ``mixed``: adds ~20%
affinity-bearing pods (soft zone co-location and required hostname
anti-affinity), ~10% disk-volume pods, node selectors, and
toleration-bearing pods for tainted capacity.
"""

from __future__ import annotations

import random

from .api import (
    Affinity,
    LabelSelector,
    ObjectMeta,
    PodAffinityTerm,
    Service,
    Taint,
    Toleration,
    Volume,
    WeightedPodAffinityTerm,
)
from .testutil import make_node, make_pod

ZONE = "failure-domain.beta.kubernetes.io/zone"


def make_nodes(n_nodes: int, rng: random.Random, workload: str):
    nodes = []
    for i in range(n_nodes):
        labels = {
            "kubernetes.io/hostname": f"node-{i:05d}",
            ZONE: f"zone-{i % 3}",
        }
        taints = []
        if workload == "mixed":
            if rng.random() < 0.3:
                labels["disk"] = rng.choice(["ssd", "hdd"])
            if rng.random() < 0.1:
                taints.append(Taint(key="dedicated", value="special", effect="NoSchedule"))
        nodes.append(
            make_node(
                f"node-{i:05d}",
                cpu=rng.choice(["8", "16", "32"]),
                memory=rng.choice(["16Gi", "32Gi", "64Gi"]),
                pods=110,
                labels=labels,
                taints=taints,
            )
        )
    return nodes


def make_services():
    return [
        Service(meta=ObjectMeta(name=app), selector={"app": app})
        for app in ("web", "api", "db")
    ]


def make_pods(n_pods: int, rng: random.Random, workload: str):
    plain_templates = [
        dict(cpu="100m", memory="128Mi", labels={"app": "web"}),
        dict(cpu="250m", memory="256Mi", labels={"app": "api"}),
        dict(cpu="500m", memory="512Mi", labels={"app": "db"}),
        dict(cpu="1", memory="1Gi", labels={"app": "batch"}),
    ]
    if workload == "plain":
        return [
            make_pod(f"pod-{i:06d}", **plain_templates[i % len(plain_templates)])
            for i in range(n_pods)
        ]

    soft = Affinity(
        pod_affinity_preferred=[
            WeightedPodAffinityTerm(
                weight=10,
                term=PodAffinityTerm(
                    selector=LabelSelector.from_match_labels({"app": "web"}),
                    topology_key=ZONE,
                ),
            )
        ]
    )
    anti = Affinity(
        pod_anti_affinity_required=[
            PodAffinityTerm(
                selector=LabelSelector.from_match_labels({"app": "lonely"}),
                topology_key="kubernetes.io/hostname",
            )
        ]
    )
    pods = []
    for i in range(n_pods):
        r = rng.random()
        if r < 0.10:
            pods.append(
                make_pod(f"soft-{i:06d}", cpu="100m", memory="128Mi",
                         labels={"app": "web"}, affinity=soft)
            )
        elif r < 0.20:
            pods.append(
                make_pod(f"lonely-{i:06d}", cpu="100m", memory="128Mi",
                         labels={"app": "lonely"}, affinity=anti)
            )
        elif r < 0.30:
            pods.append(
                make_pod(
                    f"vol-{i:06d}", cpu="100m", memory="128Mi", labels={"app": "api"},
                    volumes=[Volume(name="v", disk_id=f"pd-{rng.randrange(2 * n_pods)}",
                                    disk_kind=rng.choice(["gce-pd", "aws-ebs"]))],
                )
            )
        elif r < 0.35:
            pods.append(
                make_pod(f"ssd-{i:06d}", cpu="250m", memory="256Mi",
                         labels={"app": "db"}, node_selector={"disk": "ssd"})
            )
        elif r < 0.40:
            pods.append(
                make_pod(
                    f"tol-{i:06d}", cpu="200m", memory="128Mi", labels={"app": "batch"},
                    tolerations=[Toleration(key="dedicated", operator="Exists")],
                )
            )
        else:
            pods.append(
                make_pod(f"pod-{i:06d}", **plain_templates[i % len(plain_templates)])
            )
    return pods
