"""Catalogs: multi-table warehouses.

reference: paimon-core/.../catalog/Catalog.java (SPI),
FileSystemCatalog.java (warehouse dir layout `<wh>/<db>.db/<table>`),
CatalogFactory.createCatalog.
"""

from paimon_tpu_torch.catalog.catalog import (  # noqa: F401
    Catalog, DatabaseAlreadyExistsError, DatabaseNotFoundError,
    FileSystemCatalog, Identifier, TableAlreadyExistsError,
    TableNotFoundError, create_catalog,
)
