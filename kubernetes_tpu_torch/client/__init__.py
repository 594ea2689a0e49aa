"""Client machinery: clientset, informers, workqueue, event recording, the
HTTP store client and the leader lock."""

from .clientset import BindConflictError, Clientset, PodClient, TypedClient
from .informer import (CacheMutationError, Handler, InformerFactory, PodNodeIndex,
                       PodOwnerIndex, SharedInformer)
from .leaderelection import LeaderElector
from .record import EventBroadcaster, EventCorrelator, EventRecorder
from .remote import RemoteStore
from .workqueue import ExponentialBackoff, WorkQueue
