"""Reconciling control loops (SURVEY.md L6)."""

from .base import Controller
from .certificates import CertificateController
from .cronjob import CronJobController
from .daemonset import DaemonSetController
from .deployment import DeploymentController, template_hash
from .disruption import DisruptionController
from .endpoint import EndpointController
from .garbagecollector import GarbageCollector
from .horizontal import HorizontalPodAutoscalerController
from .job import JobController
from .manager import ControllerManager, DEFAULT_CONTROLLERS
from .namespace import NamespaceController
from .node_lifecycle import NodeLifecycleController, RateLimiter
from .podgc import PodGCController
from .replicaset import (Expectations, ReplicaSetController,
                         ReplicationControllerController)
from .resourcequota import ResourceQuotaController
from .serviceaccounts import ServiceAccountController
from .statefulset import StatefulSetController
from .ttl import TTLController
