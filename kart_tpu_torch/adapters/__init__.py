"""Adapters between Datasets V2 schemas and values and a working copy's SQL
dialect. Only the GeoPackage's is ported (:mod:`.gpkg`); the PostGIS, SQL
Server and MySQL adapters are not."""
