// Native netCDF3-classic I/O engine for the ecckd_tpu framework.
//
// Plays the role of the reference chain's compiled I/O stack (netCDF-C +
// netCDF-Fortran behind mo_simple_netcdf.F90 / mo_rfmip_io.F90,
// rte-ecckd/example/rfmip-rad-irf/): a dependency-free reader/writer
// for the netCDF3 "classic" format (CDF-1) and its 64-bit-offset variant
// (CDF-2) — the only formats used by the ckd-definition tables, the RFMIP
// atmosphere file and the CMIP flux outputs.
//
// The reader parses the header once and serves variable data with pread(),
// so multi-GB RFMIP-scale inputs stream without being resident; record
// variables (unlimited dimension) are supported with the standard
// interleaved record layout.  All multi-byte values are big-endian on disk.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace nc3 {

enum Type : int32_t {
  NC_BYTE = 1,
  NC_CHAR = 2,
  NC_SHORT = 3,
  NC_INT = 4,
  NC_FLOAT = 5,
  NC_DOUBLE = 6,
};

size_t type_size(int32_t t);

struct Dim {
  std::string name;
  int64_t size;       // 0 on disk means the record dimension
  bool is_record;
};

struct Att {
  std::string name;
  int32_t type;
  std::string text;            // NC_CHAR payload
  std::vector<double> values;  // numeric payload (converted)
};

struct Var {
  std::string name;
  std::vector<int32_t> dimids;
  std::vector<Att> atts;
  int32_t type;
  int64_t vsize;   // per-record byte size for record vars (padded)
  int64_t begin;   // file offset of first value
  bool is_record;
  int64_t num_elems_per_record;  // product of non-record dim sizes
};

class Reader {
 public:
  ~Reader();
  // Returns nullptr and sets *err on failure.
  static Reader* Open(const std::string& path, std::string* err);

  const std::vector<Dim>& dims() const { return dims_; }
  const std::vector<Var>& vars() const { return vars_; }
  const std::vector<Att>& gatts() const { return gatts_; }
  int64_t numrecs() const { return numrecs_; }

  int var_id(const std::string& name) const;
  // Full variable shape with the record dimension resolved to numrecs.
  std::vector<int64_t> var_shape(int vid) const;
  int64_t var_elems(int vid) const;
  // Reads the whole variable, converting any numeric type to double.
  bool read_var_double(int vid, double* out, std::string* err) const;

 private:
  Reader() = default;
  bool Parse(std::string* err);

  int fd_ = -1;
  int version_ = 1;  // 1: 32-bit offsets, 2: 64-bit offsets
  int64_t numrecs_ = 0;
  int64_t recsize_ = 0;  // byte stride between records
  std::vector<Dim> dims_;
  std::vector<Att> gatts_;
  std::vector<Var> vars_;
  std::vector<uint8_t> header_;  // raw header bytes
  size_t pos_ = 0;               // parse cursor
  int64_t file_size_ = 0;

  bool need(size_t n, std::string* err);
  uint32_t u32();
  int64_t offset();
  // Bounds-checked variants: every header read goes through these so a
  // truncated / corrupt / chunk-straddling header surfaces as the
  // "truncated netCDF header" sentinel (Open()'s grow-retry key) or a
  // clean parse error — never an out-of-bounds read.
  bool read_u32(uint32_t* v, std::string* err);
  bool read_offset(int64_t* v, std::string* err);
  bool read_name(std::string* s, std::string* err);
  bool parse_atts(std::vector<Att>* out, std::string* err);
};

class Writer {
 public:
  explicit Writer(std::string path) : path_(std::move(path)) {}
  int def_dim(const std::string& name, int64_t size);
  int def_var(const std::string& name, int32_t type,
              const std::vector<int32_t>& dimids);
  void put_att_text(int vid, const std::string& name,
                    const std::string& value);  // vid -1: global
  void put_att_double(int vid, const std::string& name,
                      const std::vector<double>& vals, int32_t type);
  // Data converted from double to the variable's declared type.
  bool put_var_double(int vid, const double* data, int64_t n,
                      std::string* err);
  // Lays out the header + data and writes the file (CDF-2 when needed).
  bool finish(std::string* err);

 private:
  std::string path_;
  std::vector<Dim> dims_;
  std::vector<Att> gatts_;
  std::vector<Var> vars_;
  std::vector<std::vector<uint8_t>> data_;  // per-var encoded payload
};

// In-place overwrite of an existing non-record variable's data in a file
// (the reference fills pre-existing CMIP template variables,
// mo_rfmip_io.F90:288-317).
bool UpdateVarDouble(const std::string& path, const std::string& name,
                     const double* data, int64_t n, std::string* err);

}  // namespace nc3
