"""Exception taxonomy, mirroring the reference's (``Exceptions/``)."""


class StorageError(Exception):
    """Base class for storage_tpu_torch errors."""


class InventoryConstraintsCannotBeFulfilledError(StorageError):
    """Inventory constraints admit no feasible path.

    Reference: ``InventoryConstraintsCannotBeFulfilledException``
    (``Exceptions/InventoryConstraintsCannotBeFulfilledException.cs``), thrown
    by the inventory-space reduction when the forward and backward reachable
    ranges have empty intersection (``StorageHelper.cs:101-102``).
    """

    def __init__(self, message: str = "Inventory constraints cannot be fulfilled."):
        super().__init__(message)
