// Native host components of dflo_tpu_torch: a copy of the reference
// package's native/dflo_native.cc (msh_parse, msh_free, vtu_write).
//
//  - msh_parse:  Gmsh 2.x ASCII mesh reader (replaces GridIn::read_msh,
//                src/claw.cc:956-967): nodes, quad elements and boundary
//                line elements with physical ids.
//  - vtu_write:  appended-binary VTU writer (replaces DataOut::write_vtu,
//                src/output.cc:32-107).
//
// Exposed through a plain C ABI to ctypes (dflo_tpu_torch/native).  Built at
// first use with g++ -O3 -fPIC -std=c++17 -shared into
// dflo_tpu_torch/_build/, keyed by a hash of this file.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct MshData {
  int64_t n_nodes;
  int64_t* node_ids;   // [n_nodes]
  double* xy;          // [n_nodes * 2]
  int64_t n_quads;
  int64_t* quads;      // [n_quads * 5]  (4 node ids + physical id)
  int64_t n_lines;
  int64_t* lines;      // [n_lines * 3]  (2 node ids + physical id)
  char error[256];
};

static void set_error(MshData* d, const char* msg) {
  std::snprintf(d->error, sizeof(d->error), "%s", msg);
}

MshData* msh_parse(const char* path) {
  MshData* d = (MshData*)std::calloc(1, sizeof(MshData));
  if (!d) return nullptr;
  FILE* f = std::fopen(path, "r");
  if (!f) {
    set_error(d, "cannot open file");
    return d;
  }

  std::vector<int64_t> node_ids;
  std::vector<double> xy;
  std::vector<int64_t> quads;
  std::vector<int64_t> lines;

  char buf[1024];
  while (std::fgets(buf, sizeof(buf), f)) {
    if (std::strncmp(buf, "$MeshFormat", 11) == 0) {
      double ver = 0;
      if (std::fgets(buf, sizeof(buf), f)) std::sscanf(buf, "%lf", &ver);
      if (ver < 2.0 || ver >= 3.0) {
        set_error(d, "unsupported .msh version (need 2.x ASCII)");
        std::fclose(f);
        return d;
      }
    } else if (std::strncmp(buf, "$Nodes", 6) == 0) {
      long long n = 0;
      if (!std::fgets(buf, sizeof(buf), f) ||
          std::sscanf(buf, "%lld", &n) != 1) {
        set_error(d, "bad $Nodes header");
        std::fclose(f);
        return d;
      }
      node_ids.reserve(n);
      xy.reserve(2 * n);
      for (long long i = 0; i < n; ++i) {
        long long id;
        double x, y, z;
        if (!std::fgets(buf, sizeof(buf), f) ||
            std::sscanf(buf, "%lld %lf %lf %lf", &id, &x, &y, &z) < 3) {
          set_error(d, "bad node line");
          std::fclose(f);
          return d;
        }
        node_ids.push_back(id);
        xy.push_back(x);
        xy.push_back(y);
      }
    } else if (std::strncmp(buf, "$Elements", 9) == 0) {
      long long n = 0;
      if (!std::fgets(buf, sizeof(buf), f) ||
          std::sscanf(buf, "%lld", &n) != 1) {
        set_error(d, "bad $Elements header");
        std::fclose(f);
        return d;
      }
      for (long long i = 0; i < n; ++i) {
        if (!std::fgets(buf, sizeof(buf), f)) {
          set_error(d, "truncated $Elements");
          std::fclose(f);
          return d;
        }
        long long vals[32];
        int cnt = 0;
        char* p = buf;
        while (cnt < 32) {
          char* end;
          long long v = std::strtoll(p, &end, 10);
          if (end == p) break;
          vals[cnt++] = v;
          p = end;
        }
        if (cnt < 3) continue;
        const long long etype = vals[1];
        const long long ntags = vals[2];
        const long long phys = ntags > 0 ? vals[3] : 0;
        const long long* conn = vals + 3 + ntags;
        const int nconn = cnt - 3 - (int)ntags;
        if (etype == 1 && nconn >= 2) {         // 2-node line
          lines.push_back(conn[0]);
          lines.push_back(conn[1]);
          lines.push_back(phys);
        } else if (etype == 3 && nconn >= 4) {  // 4-node quad
          for (int k = 0; k < 4; ++k) quads.push_back(conn[k]);
          quads.push_back(phys);
        }
      }
    }
  }
  std::fclose(f);

  d->n_nodes = (int64_t)node_ids.size();
  d->n_quads = (int64_t)(quads.size() / 5);
  d->n_lines = (int64_t)(lines.size() / 3);
  d->node_ids = (int64_t*)std::malloc(node_ids.size() * sizeof(int64_t));
  d->xy = (double*)std::malloc(xy.size() * sizeof(double));
  d->quads = (int64_t*)std::malloc(quads.size() * sizeof(int64_t));
  d->lines = (int64_t*)std::malloc(lines.size() * sizeof(int64_t));
  std::memcpy(d->node_ids, node_ids.data(), node_ids.size() * sizeof(int64_t));
  std::memcpy(d->xy, xy.data(), xy.size() * sizeof(double));
  std::memcpy(d->quads, quads.data(), quads.size() * sizeof(int64_t));
  std::memcpy(d->lines, lines.data(), lines.size() * sizeof(int64_t));
  return d;
}

void msh_free(MshData* d) {
  if (!d) return;
  std::free(d->node_ids);
  std::free(d->xy);
  std::free(d->quads);
  std::free(d->lines);
  std::free(d);
}

// ---------------------------------------------------------------------------
// appended-binary VTU writer
// ---------------------------------------------------------------------------

static void write_data_array_header(FILE* f, const char* type,
                                    const char* name, int ncomp,
                                    size_t offset) {
  std::fprintf(f,
               "<DataArray type=\"%s\" Name=\"%s\" NumberOfComponents=\"%d\" "
               "format=\"appended\" offset=\"%zu\"/>\n",
               type, name, ncomp, offset);
}

// points [npts*3] f64, conn [ncell*4] i32, point fields: nf arrays [npts],
// names as '\n'-joined string; cell fields analogous.
int vtu_write(const char* path, int64_t npts, const double* points,
              int64_t ncells, const int32_t* conn, int nf,
              const char* names, const double* const* fields, int ncf,
              const char* cell_names, const double* const* cell_fields,
              double time) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;

  // split names
  std::vector<std::string> pf_names, cf_names;
  {
    std::string s(names ? names : "");
    size_t pos = 0;
    while (pos < s.size()) {
      size_t nl = s.find('\n', pos);
      if (nl == std::string::npos) nl = s.size();
      pf_names.push_back(s.substr(pos, nl - pos));
      pos = nl + 1;
    }
    std::string c(cell_names ? cell_names : "");
    pos = 0;
    while (pos < c.size()) {
      size_t nl = c.find('\n', pos);
      if (nl == std::string::npos) nl = c.size();
      cf_names.push_back(c.substr(pos, nl - pos));
      pos = nl + 1;
    }
  }

  std::fprintf(f, "<?xml version=\"1.0\"?>\n");
  std::fprintf(f, "<VTKFile type=\"UnstructuredGrid\" version=\"0.1\" "
                  "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n");
  std::fprintf(f, "<UnstructuredGrid>\n");
  std::fprintf(f,
               "<FieldData><DataArray type=\"Float64\" Name=\"TimeValue\" "
               "NumberOfTuples=\"1\" format=\"ascii\">%.17g</DataArray>"
               "</FieldData>\n",
               time);
  std::fprintf(f, "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
               (long long)npts, (long long)ncells);

  size_t offset = 0;
  auto adv = [&](size_t nbytes) {
    size_t o = offset;
    offset += sizeof(uint64_t) + nbytes;
    return o;
  };

  std::fprintf(f, "<Points>\n");
  write_data_array_header(f, "Float64", "Points", 3, adv(npts * 3 * 8));
  std::fprintf(f, "</Points>\n<Cells>\n");
  write_data_array_header(f, "Int32", "connectivity", 1, adv(ncells * 4 * 4));
  write_data_array_header(f, "Int32", "offsets", 1, adv(ncells * 4));
  write_data_array_header(f, "UInt8", "types", 1, adv(ncells));
  std::fprintf(f, "</Cells>\n<PointData>\n");
  for (int i = 0; i < nf; ++i)
    write_data_array_header(f, "Float64", pf_names[i].c_str(), 1,
                            adv(npts * 8));
  std::fprintf(f, "</PointData>\n<CellData>\n");
  for (int i = 0; i < ncf; ++i)
    write_data_array_header(f, "Float64", cf_names[i].c_str(), 1,
                            adv(ncells * 8));
  std::fprintf(f, "</CellData>\n</Piece>\n</UnstructuredGrid>\n");
  std::fprintf(f, "<AppendedData encoding=\"raw\">\n_");

  auto put_block = [&](const void* data, size_t nbytes) {
    uint64_t len = (uint64_t)nbytes;
    std::fwrite(&len, sizeof(len), 1, f);
    std::fwrite(data, 1, nbytes, f);
  };

  put_block(points, npts * 3 * 8);
  put_block(conn, ncells * 4 * 4);
  {
    std::vector<int32_t> offs(ncells);
    for (int64_t i = 0; i < ncells; ++i) offs[i] = (int32_t)(4 * (i + 1));
    put_block(offs.data(), ncells * 4);
    std::vector<uint8_t> types(ncells, 9);  // VTK_QUAD
    put_block(types.data(), ncells);
  }
  for (int i = 0; i < nf; ++i) put_block(fields[i], npts * 8);
  for (int i = 0; i < ncf; ++i) put_block(cell_fields[i], ncells * 8);

  std::fprintf(f, "\n</AppendedData>\n</VTKFile>\n");
  std::fclose(f);
  return 0;
}

}  // extern "C"
