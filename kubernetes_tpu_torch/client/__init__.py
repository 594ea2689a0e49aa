"""Client machinery: clientset, informers, workqueue, event recording."""

from .clientset import BindConflictError, Clientset, PodClient, TypedClient
from .informer import Handler, InformerFactory, SharedInformer
from .record import EventBroadcaster, EventCorrelator, EventRecorder
from .workqueue import ExponentialBackoff, WorkQueue
