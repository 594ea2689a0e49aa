"""Cloud provider layer (SURVEY.md §1-L6 cloud split:
``pkg/cloudprovider`` + ``cmd/cloud-controller-manager``)."""

from .controllers import CloudNodeController, RouteController, ServiceLBController
from .manager import CLOUD_CONTROLLERS, CloudControllerManager, CloudMetrics
from .provider import (
    CloudProvider,
    FakeCloud,
    Instance,
    LoadBalancer,
    Route,
)
