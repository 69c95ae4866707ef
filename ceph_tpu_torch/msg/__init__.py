from ceph_tpu_torch.msg.auth import AuthError, Authenticator, Keyring
from ceph_tpu_torch.msg.message import Message, register
from ceph_tpu_torch.msg.messenger import (
    MODE_CRC, MODE_SECURE, Connection, ConnectionError_, Dispatcher,
    EntityAddr, Messenger, Policy, Throttle,
)

__all__ = [
    "AuthError", "Authenticator", "Keyring",
    "Message", "register",
    "Connection", "ConnectionError_", "Dispatcher", "EntityAddr",
    "Messenger", "Policy", "Throttle", "MODE_CRC", "MODE_SECURE",
]
